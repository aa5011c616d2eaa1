"""Paged KV-cache attention ops under the serving engine: counterpart of
paddle_tpu/ops/paged_attention.py (fp and int8 pools, one device).

Pool layout `[num_layers, num_blocks, block_size, heads, head_dim]`, block 0
the null block: idle decode lanes and padded prefill positions write there,
and no allocator hands it out. A slot's block table maps its logical
positions to pool blocks. Every op here updates the pools IN PLACE (the JAX
package chains functional updates that XLA aliases in place under donation;
PyTorch writes them directly).

- `paged_attention_step`: one batched decode step, through the paged decode
  kernel's wrapper (`ops/paged_decode.py`), whose plain version
  `paged_decode_plain` is the port of `_dense_step`.
- `paged_verify_window`: one speculative verify step over a `[slots, K+1]`
  window, through the verify kernel's wrapper (`ops/paged_verify.py`),
  whose plain version is the port of `_dense_verify`.
- `resolve_backend`: the engine's `attention_backend` seam. Both steps
  take `backend`: `pallas` goes through the kernels' wrappers, `dense`
  calls the plain versions (the JAX package's dense paths) on every
  device, counted in each step's `.dense_calls`.
- `paged_prefill_chunk`: one chunk of chunked prefill for one slot, and
  `paged_prefill_write`: a bucketed prefill's k/v written in one scatter.
  The JAX package runs both outside Pallas, so they stay plain PyTorch
  here.
- `copy_pool_block`: the engine's copy-on-write step.
- `export_pool_block` / `ingest_pool_block`: the disaggregated handoff's
  transfer unit (`inference.fleet`): one block's rows of every layer (and
  its int8 scale rows) copied out of a prefill replica's pools, then
  written into a block of a decode replica's. Bit copies, never
  re-quantized. The export is a copy, not a view: the source block goes
  back to its allocator at once and may be rewritten before the payload
  lands. JAX compiles the pair once with traced block ids and donated
  destination pools; here both are eager PyTorch ops, ordered on the
  current stream after the step that wrote the rows.
- `dense_gather_reference`: a parity probe reassembling one slot's rows.

int8 KV (`scales`, the engine's `[layers, num_blocks, 2]` f32 per-block
K/V grid; column 0 K, column 1 V): the pools hold int8 codes. Every write
path quantizes on write in plain torch on every device, as the JAX package
does outside Pallas: symmetric absmax clipped to +-127, per-block scales
that only grow (a write whose absmax exceeds the block's grid grows it and
requantizes the block's rows, `round(q * s_old / s_new)`, before the new
rows land), scale rows reset to `KV_QUANT_EPS` when the allocator hands a
block out. Only the written (engine-guaranteed private) blocks change.
The decode and verify steps then hand the quantized rows and this layer's
`[num_blocks, 2]` plane to their int8 kernels (`_decode_kernel_int8`,
`_verify_kernel_int8`), which dequantize per streamed block.

Tensor-parallel serving (the `*_shards` editions of the steps): the pools
are head-sharded, one `[layers, num_blocks, block_size, heads / mp,
head_dim]` plane pair a shard on its device, and each edition takes
per-shard lists in mesh order (q/k/v, pools, block tables, positions)
and returns the per-shard outputs. The block tables are the same on every
shard. Under int8 the per-block grids stay GLOBAL: the scale array is
replicated (one per distinct device; shards on one device share it), and
every write folds the shards' absmax candidates with one max over the
shards in mesh order (`_fold_amax`, exact), so each shard grows and
requantizes its own heads on the grid mp=1 would choose. One shard is the
single-device path, bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import on_device
from .paged_decode import (_BLOCK_SIZES, _HEAD_DIMS, paged_decode_attention,
                           paged_decode_attention_int8,
                           paged_decode_int8_plain, paged_decode_plain)
from .paged_verify import (paged_verify_attention,
                           paged_verify_attention_int8,
                           paged_verify_int8_plain, paged_verify_plain)

__all__ = ["PAGED_BACKENDS", "resolve_backend", "paged_attention_step",
           "paged_verify_window", "paged_prefill_chunk",
           "paged_prefill_write", "paged_attention_step_shards",
           "paged_verify_window_shards", "paged_prefill_chunk_shards",
           "paged_prefill_write_shards", "copy_pool_block",
           "export_pool_block", "ingest_pool_block",
           "export_pool_block_shards", "ingest_pool_block_shards",
           "dense_gather_reference", "KV_QUANT_EPS"]

#: Scale floor of the int8 per-block-quantized KV cache (the JAX package's
#: value): fresh blocks' scale rows are reset here, so a stale tenant's
#: grid never quantizes a new one's rows.
KV_QUANT_EPS = 1e-8

# amax / 127 as the JAX engine computes it: under jit XLA rewrites the
# division by the constant 127 into a multiply by its f32 reciprocal, and
# the scale grids differ by an ulp if this divides instead (the tests
# compare with jitted JAX). The Python float holds the f32 value exactly.
_INV127 = float(np.float32(1.0) / np.float32(127.0))


def _requant_grow(blk, factor):
    """Rescale a written block's int8 rows onto a grown grid: factor =
    s_old / s_new <= 1, so the round (half to even, as `jnp.round`)
    never needs a clip."""
    return torch.round(blk.float() * factor).to(torch.int8)


def _quant_rows(rows, s):
    """Quantize fp rows onto the block grid `s` (broadcast f32)."""
    return torch.clamp(torch.round(rows.float() / s), -127, 127) \
        .to(torch.int8)


def _to(t, dev):
    return t if t.device == dev else t.to(dev)


def _distinct(tensors):
    """Each tensor once (by identity), in order: the scale replicas of a
    mesh whose shards share a device are one tensor."""
    return list({id(t): t for t in tensors}.values())


def _fold_amax(amaxes):
    """Per-block scale candidates must cover ALL heads; under a
    head-sharded mesh each shard sees only its own, so the shards'
    candidates fold with one max in mesh order, on the first shard's
    device (exact: max is associative and commutative). One shard's
    candidates pass through."""
    out = amaxes[0]
    for a in amaxes[1:]:
        out = torch.maximum(out, _to(a, out.device))
    return out


def _grow_blocks(kpools, vpools, scales, layer, bids, amax):
    """Grow the grids of blocks `bids` (any shape) to cover `amax`
    (`bids.shape + (2,)`, already divided by 127 and folded), requantize
    every shard's rows of them IN PLACE and store the new scale rows in
    every replica; returns the new scales (on the first shard's
    device)."""
    s_old = scales[0][layer, bids]
    s_new = torch.clamp_min(torch.maximum(s_old, amax), KV_QUANT_EPS)
    fac = s_old / s_new
    tail = (None,) * 3                       # over [bs, heads, D]
    for kpool, vpool in zip(kpools, vpools):
        b, f = _to(bids, kpool.device), _to(fac, kpool.device)
        kpool[layer, b] = _requant_grow(kpool[layer, b], f[(..., 0) + tail])
        vpool[layer, b] = _requant_grow(vpool[layer, b], f[(..., 1) + tail])
    for sc in _distinct(scales):
        sc[layer, _to(bids, sc.device)] = _to(s_new, sc.device)
    return s_new


def _row_absmax(x, dims):
    return x.float().abs().amax(dim=dims)


def _quant_write_decode_shards(kpools, vpools, scales, ks, vs, block_tables,
                               positions, layer):
    """Quant-on-write bookkeeping for one decode row per slot (the port of
    `_quant_write_decode`) over a mesh's shards: grow + requantize each
    slot's write block on every shard and update its scale row, IN PLACE.
    `block_tables`, `positions`: the first shard's. Returns each shard's
    quantized new rows `(kq, vq)`, `[slots, heads, D]` int8, not yet
    written (the kernel lands them)."""
    bs = kpools[0].shape[2]
    pos = positions.long()
    bid_w = block_tables.long().gather(1, (pos // bs)[:, None])[:, 0]
    amax = _fold_amax([torch.stack([_row_absmax(k[:, 0], (1, 2)),
                                    _row_absmax(v[:, 0], (1, 2))], -1)
                       * _INV127 for k, v in zip(ks, vs)])
    s_new = _grow_blocks(kpools, vpools, scales, layer, bid_w, amax)
    out = []
    for k, v in zip(ks, vs):
        s = _to(s_new, k.device)
        out.append((_quant_rows(k[:, 0], s[:, 0, None, None]),
                    _quant_rows(v[:, 0], s[:, 1, None, None])))
    return out


def _quant_write_decode(kpool, vpool, scales, k, v, block_tables, positions,
                        layer):
    """One device's `_quant_write_decode_shards`: returns `(kq, vq)`."""
    return _quant_write_decode_shards([kpool], [vpool], [scales], [k], [v],
                                      block_tables, positions, layer)[0]


def _quant_write_window_shards(kpools, vpools, scales, ks, vs, block_tables,
                               positions, draft_lens, layer):
    """Window edition (the port of `_quant_write_window`): W contiguous
    write positions per slot span a fixed number of candidate table slots,
    `(W - 1) // bs + 2`; dead rows (i > draft_len) stay out of the absmax.
    Candidates past the table route to the null block, so a clamped index
    never races the real last block's grid. Index tensors: the first
    shard's. Returns each shard's `(kq, vq)`, `[slots, W, heads, D]`
    int8."""
    B, W = ks[0].shape[:2]
    bs = kpools[0].shape[2]
    maxb = block_tables.shape[1]
    dev = block_tables.device
    nb = (W - 1) // bs + 2
    bt = block_tables.long()
    pos = positions.long()
    ar = torch.arange(W, device=dev)
    wpos = pos[:, None] + ar[None, :]                      # [B, W]
    live = ar[None, :] <= draft_lens.long()[:, None]
    first = pos // bs
    seg = torch.clamp(wpos // bs - first[:, None], 0, nb - 1)
    cand = first[:, None] + torch.arange(nb, device=dev)[None, :]
    bids = torch.where(cand <= maxb - 1,
                       bt.gather(1, torch.clamp_max(cand, maxb - 1)),
                       torch.zeros_like(cand))              # [B, nb]

    def need(x):                       # per-candidate absmax of live rows
        lv, sg = _to(live, x.device), _to(seg, x.device)
        rows = torch.where(lv, _row_absmax(x, (2, 3)), 0.0)
        return torch.zeros((B, nb), dtype=torch.float32, device=x.device) \
            .scatter_reduce(1, sg, rows, reduce="amax")

    amax = _fold_amax([torch.stack([need(k), need(v)], -1) * _INV127
                       for k, v in zip(ks, vs)])            # [B, nb, 2]
    s_new = _grow_blocks(kpools, vpools, scales, layer, bids, amax)
    s_row = s_new.gather(1, seg[..., None].expand(B, W, 2))
    out = []
    for k, v in zip(ks, vs):
        s = _to(s_row, k.device)
        out.append((_quant_rows(k, s[..., 0, None, None]),
                    _quant_rows(v, s[..., 1, None, None])))
    return out


def _quant_write_window(kpool, vpool, scales, k, v, block_tables, positions,
                        draft_lens, layer):
    """One device's `_quant_write_window_shards`: returns `(kq, vq)`."""
    return _quant_write_window_shards([kpool], [vpool], [scales], [k], [v],
                                      block_tables, positions, draft_lens,
                                      layer)[0]


PAGED_BACKENDS = ("auto", "dense", "pallas")


def resolve_backend(backend, head_dim, block_size):
    """Resolve `auto`/`dense`/`pallas` to the backend the engine's steps
    run, once (JAX's `resolve_backend`). An explicit `dense` or `pallas`
    wins; `pallas` names the CUDA kernels. `auto` follows JAX's rule, dense
    at head_dim < 64 or block_size < 8, and is also dense where the CUDA
    kernels do not take the shape (head_dim not in {64, 128}, block_size
    not in {8, 16, 32, 64}); otherwise the kernels, on every device (their
    plain versions on the CPU), where JAX's `auto` takes them on a TPU
    only."""
    if backend not in PAGED_BACKENDS:
        raise ValueError(f"backend must be one of {PAGED_BACKENDS}, "
                         f"got {backend!r}")
    if backend != "auto":
        return backend
    if (head_dim >= 64 and block_size >= 8 and head_dim in _HEAD_DIMS
            and block_size in _BLOCK_SIZES):
        return "pallas"
    return "dense"


def _on(t, fn, *args):
    """`fn(*args)` with `t`'s card current (a shard's kernels launch on
    its own card; nothing for a CPU tensor)."""
    with on_device(t):
        return fn(*args)


def _dense(step, backend):
    if backend not in ("dense", "pallas"):
        raise ValueError(f"backend must be 'dense' or 'pallas' (resolve "
                         f"'auto' first), got {backend!r}")
    if backend == "dense":
        step.dense_calls += 1
        return True
    return False


def paged_attention_step(q, k, v, kpool, vpool, layer, block_tables,
                         positions, scale=None, scales=None,
                         backend="pallas"):
    """One batched decode step against the paged cache, for one layer.

    q/k/v `[slots, 1, heads, head_dim]` (any strides); pools updated IN
    PLACE; block_tables `[slots, max_blocks]` and positions `[slots]`
    int32. Writes k/v at `(block_tables[s, pos // bs], pos % bs)` per slot,
    then attends q over the slot's positions `<= pos`. Idle slots are
    (position 0, all-null table). With `scales` the pools are int8: the
    step quantizes on write (scales updated IN PLACE) and runs the int8
    kernel at the default softmax scale. `backend` "pallas" runs the
    kernel's wrapper, "dense" its plain version. Returns
    `out [slots, 1, heads, head_dim]`.
    """
    return paged_attention_step_shards(
        [q], [k], [v], [kpool], [vpool], layer, [block_tables], [positions],
        scale, None if scales is None else [scales], backend)[0]


def paged_attention_step_shards(qs, ks, vs, kpools, vpools, layer,
                                block_tables, positions, scale=None,
                                scales=None, backend="pallas"):
    """`paged_attention_step` over a mesh's shards: every argument but
    `layer`, `scale` and `backend` a per-shard list in mesh order (each
    shard's heads, pools and copies of the tables and positions on its
    device; `scales` the replicas). Each shard runs the step on its heads
    (the kernel once a shard); int8 writes fold the shards' absmax first.
    Returns the per-shard outputs."""
    dense = _dense(paged_attention_step, backend)
    if scales is None:
        fn = paged_decode_plain if dense else paged_decode_attention
        return [_on(kp, fn, q.contiguous(), k.contiguous(), v.contiguous(),
                     kp, vp, layer, bt, pos, scale)
                for q, k, v, kp, vp, bt, pos in zip(
                    qs, ks, vs, kpools, vpools, block_tables, positions)]
    if scale is not None:
        raise ValueError("int8 pools take the default softmax scale")
    rows = _quant_write_decode_shards(kpools, vpools, scales, ks, vs,
                                      block_tables[0], positions[0], layer)
    fn = paged_decode_int8_plain if dense else paged_decode_attention_int8
    return [_on(kp, fn, q.contiguous(), kq[:, None].contiguous(),
                 vq[:, None].contiguous(), kp, vp, sc[layer], layer, bt, pos)
            for q, (kq, vq), kp, vp, sc, bt, pos in zip(
                qs, rows, kpools, vpools, scales, block_tables, positions)]


paged_attention_step.dense_calls = 0


def paged_verify_window(q, k, v, kpool, vpool, layer, block_tables,
                        positions, draft_lens, scales=None,
                        backend="pallas"):
    """Speculative-verify attention over a fixed `[slots, W]` window
    (W = K+1), for one layer.

    q/k/v `[slots, W, heads, head_dim]` (any strides): the feed token's
    projections at row 0, the drafted tokens' after it. Pools updated IN
    PLACE; block_tables `[slots, max_blocks]`, positions `[slots]` (window
    row 0's absolute position) and draft_lens `[slots]` in `[0, W-1]`, all
    int32. Row i is live iff `i <= draft_lens[s]`: live rows write through
    the table, dead rows the null block, and every row attends causally up
    to its own position. Idle lanes are (position 0, draft length 0,
    all-null table). With `scales` the pools are int8 (window
    quant-on-write, then the int8 kernel). `backend` as
    `paged_attention_step`. Returns `out [slots, W, heads, head_dim]`;
    dead rows' outputs are garbage."""
    return paged_verify_window_shards(
        [q], [k], [v], [kpool], [vpool], layer, [block_tables], [positions],
        [draft_lens], None if scales is None else [scales], backend)[0]


def paged_verify_window_shards(qs, ks, vs, kpools, vpools, layer,
                               block_tables, positions, draft_lens,
                               scales=None, backend="pallas"):
    """`paged_verify_window` over a mesh's shards, in the terms of
    `paged_attention_step_shards`."""
    dense = _dense(paged_verify_window, backend)
    if scales is None:
        fn = paged_verify_plain if dense else paged_verify_attention
        return [_on(kp, fn, q.contiguous(), k.contiguous(), v.contiguous(),
                     kp, vp, layer, bt, pos, dl)
                for q, k, v, kp, vp, bt, pos, dl in zip(
                    qs, ks, vs, kpools, vpools, block_tables, positions,
                    draft_lens)]
    rows = _quant_write_window_shards(kpools, vpools, scales, ks, vs,
                                      block_tables[0], positions[0],
                                      draft_lens[0], layer)
    fn = paged_verify_int8_plain if dense else paged_verify_attention_int8
    return [_on(kp, fn, q.contiguous(), kq, vq, kp, vp, sc[layer], layer, bt,
                 pos, dl)
            for q, (kq, vq), kp, vp, sc, bt, pos, dl in zip(
                qs, rows, kpools, vpools, scales, block_tables, positions,
                draft_lens)]


paged_verify_window.dense_calls = 0


def _chunk_rows(block_row, start, plen, C, bs):
    """A prefill chunk's absolute positions, and the pool block and offset
    each lands in (positions `>= plen` land in the null block)."""
    maxb = block_row.shape[0]
    row = block_row.long()
    pos = start + torch.arange(C, device=block_row.device)
    valid = pos < plen
    bid = torch.where(valid, row[torch.clamp_max(pos // bs, maxb - 1)],
                      torch.zeros_like(pos))
    return row, pos, valid, bid, pos % bs


def paged_prefill_chunk(q, k, v, kpool, vpool, layer, block_row, start,
                        plen, scale=None, scales=None):
    """One chunked-prefill step for ONE slot, one layer: write the chunk's
    k/v into the pools IN PLACE, then attend the chunk's queries over the
    slot's whole context so far (shared prefix blocks, earlier chunks, the
    chunk itself), causally by absolute position.

    q/k/v `[1, C, heads, head_dim]`; block_row `[max_blocks]` int32 (on the
    pools' device); start, plen host ints: the chunk's first absolute
    position and the true prompt length. Chunk positions `>= plen` (tail
    padding) write the null block and their outputs are garbage the caller
    ignores. Returns `out [1, C, heads, head_dim]`.

    Where the JAX package runs a per-block online softmax in a loop, this
    gathers the slot's blocks once and takes one masked fp32 softmax: the
    same function up to fp32 rounding (the tests hold the two within 1e-5
    at fp32). Same numerics policy otherwise: q rounded to the pool dtype,
    probabilities to the V dtype, fp32 logits and accumulation, one cast.
    With `scales` (int8 pools) see `_prefill_chunk_int8`."""
    return paged_prefill_chunk_shards(
        [q], [k], [v], [kpool], [vpool], layer, [block_row], start, plen,
        scale, None if scales is None else [scales])[0]


def paged_prefill_chunk_shards(qs, ks, vs, kpools, vpools, layer,
                               block_rows, start, plen, scale=None,
                               scales=None):
    """`paged_prefill_chunk` over a mesh's shards, in the terms of
    `paged_attention_step_shards` (start, plen host ints)."""
    if scales is not None:
        if scale is not None:
            raise ValueError("int8 pools take the default softmax scale")
        return _prefill_chunk_int8(qs, ks, vs, kpools, vpools, scales, layer,
                                   block_rows, start, plen)
    return [_prefill_chunk_fp(q, k, v, kp, vp, layer, row, start, plen,
                              scale)
            for q, k, v, kp, vp, row in zip(qs, ks, vs, kpools, vpools,
                                            block_rows)]


def _prefill_chunk_fp(q, k, v, kpool, vpool, layer, block_row, start, plen,
                      scale):
    C, heads, d = q.shape[1], q.shape[2], q.shape[3]
    bs = kpool.shape[2]
    dev = kpool.device
    row, pos, _, bid, off = _chunk_rows(block_row, start, plen, C, bs)
    kpool[layer, bid, off] = k[0].to(kpool.dtype)
    vpool[layer, bid, off] = v[0].to(vpool.dtype)
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    end = min(start + C, plen)
    hw = max(end - 1, 0) // bs + 1
    blocks = row[:hw]
    keys = kpool[layer, blocks].reshape(hw * bs, heads, d).float()
    vals = vpool[layer, blocks].reshape(hw * bs, heads, d)
    qf = q[0].to(kpool.dtype).float()                      # [C, heads, d]
    logits = torch.einsum("chd,khd->hck", qf, keys) * s
    allowed = torch.arange(hw * bs, device=dev)[None, :] <= pos[:, None]
    logits = torch.where(allowed[None], logits,
                         torch.full_like(logits, -1e30))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)                              # [heads, C, K]
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("hck,khd->hcd", p.to(vals.dtype).float(),
                       vals.float())
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out.transpose(0, 1)[None]                       # [1, C, heads, d]


def _prefill_chunk_int8(qs, ks, vs, kpools, vpools, scales, layer,
                        block_rows, start, plen):
    """The int8 branch of `paged_prefill_chunk` (JAX `fnq`) over a mesh's
    shards: a chunk may finish a block an earlier chunk started, so each
    candidate block the chunk spans grows its grid, on the shards' folded
    absmax, and every shard requantizes its rows (candidates without valid
    rows keep their scale: factor 1, exact; candidates past the table
    route to the null block); then each shard's chunk rows land quantized
    and its queries attend as the fp branch does, gathered and with one
    masked softmax, over dequantized keys: logits `(q.k) * s * ks`,
    probabilities not rounded, each key's `p * vs` before PV."""
    C = qs[0].shape[1]
    bs = kpools[0].shape[2]
    maxb = block_rows[0].shape[0]
    nb = (C - 1) // bs + 2
    row, pos, valid, _, _ = _chunk_rows(block_rows[0], start, plen, C, bs)
    dev = row.device
    first = start // bs
    seg = torch.clamp(pos // bs - first, 0, nb - 1)
    cand = first + torch.arange(nb, device=dev)
    bids = torch.where(cand <= maxb - 1, row[torch.clamp_max(cand, maxb - 1)],
                       torch.zeros_like(cand))

    def need(x):
        vl, sg = _to(valid, x.device), _to(seg, x.device)
        rows = torch.where(vl, _row_absmax(x[0], (1, 2)), 0.0)
        return torch.zeros(nb, dtype=torch.float32, device=x.device) \
            .scatter_reduce(0, sg, rows, reduce="amax")

    amax = _fold_amax([torch.stack([need(k), need(v)], -1) * _INV127
                       for k, v in zip(ks, vs)])            # [nb, 2]
    s_new = _grow_blocks(kpools, vpools, scales, layer, bids, amax)
    s_row = s_new[seg]                                     # [C, 2]
    outs = []
    for q, k, v, kpool, vpool, sc, brow in zip(qs, ks, vs, kpools, vpools,
                                               scales, block_rows):
        d = q.shape[3]
        row, pos, _, bid, off = _chunk_rows(brow, start, plen, C, bs)
        sr = _to(s_row, kpool.device)
        kpool[layer, bid, off] = _quant_rows(k[0], sr[:, 0, None, None])
        vpool[layer, bid, off] = _quant_rows(v[0], sr[:, 1, None, None])
        outs.append(_chunk_attend_int8(q, kpool, vpool, sc, layer, row, pos,
                                       start, plen))
    return outs


def _chunk_attend_int8(q, kpool, vpool, scales, layer, row, pos, start,
                       plen):
    """A chunk's queries over its slot's int8 context (one shard)."""
    C, heads, d = q.shape[1], q.shape[2], q.shape[3]
    bs = kpool.shape[2]
    s = 1.0 / math.sqrt(d)
    end = min(start + C, plen)
    hw = max(end - 1, 0) // bs + 1
    blocks = row[:hw]
    keys = kpool[layer, blocks].reshape(hw * bs, heads, d).float()
    vals = vpool[layer, blocks].reshape(hw * bs, heads, d).float()
    ks = scales[layer, blocks, 0].repeat_interleave(bs)    # per key
    vs = scales[layer, blocks, 1].repeat_interleave(bs)
    logits = torch.einsum("chd,khd->hck", q[0].float(), keys) * s * ks
    allowed = torch.arange(hw * bs, device=kpool.device)[None, :] \
        <= pos[:, None]
    logits = torch.where(allowed[None], logits,
                         torch.full_like(logits, -1e30))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)                              # [heads, C, K]
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("hck,khd->hcd", p * vs, vals)
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out.transpose(0, 1)[None]                       # [1, C, heads, d]


def paged_prefill_write(kpool, vpool, kstack, vstack, block_row, plen,
                        scales=None):
    """Scatter a bucketed prefill's per-layer k/v into the pools, IN PLACE
    (the port of `paged_prefill_write`, plain torch as JAX computes it in
    XLA).

    kstack/vstack `[layers, 1, S, heads, head_dim]` from
    `GPTModel.forward_prefill` over the bucket-padded prompt; block_row
    `[max_blocks]` int32 (the slot's table, on the pools' device); plen
    the true prompt length, a host int. Positions `>= plen` (bucket
    padding) land in the null block 0. With `scales` (int8 pools) each
    written block's grid is the order-independent max of its scale, the
    floor and the amax of the rows landing in it (the bucketed path
    writes only freshly allocated blocks, whose grids the allocator reset
    to the floor, so nothing already written needs requantizing); then the
    rows are quantized onto their block's grid."""
    paged_prefill_write_shards([kpool], [vpool], [kstack], [vstack],
                               [block_row], plen,
                               None if scales is None else [scales])


def paged_prefill_write_shards(kpools, vpools, kstacks, vstacks, block_rows,
                               plen, scales=None):
    """`paged_prefill_write` over a mesh's shards (each shard's heads of
    the stacks into its pools); int8 grids from the shards' folded
    absmax."""
    S = kstacks[0].shape[2]
    bs = kpools[0].shape[2]
    maxb = block_rows[0].shape[0]

    def rows_of(block_row):
        row, pos, valid, bid, off = _chunk_rows(block_row, 0, plen, S, bs)
        return row, pos, valid, bid, off

    if scales is None:
        for kpool, vpool, kstack, vstack, brow in zip(
                kpools, vpools, kstacks, vstacks, block_rows):
            _, _, _, bid, off = rows_of(brow)
            kpool[:, bid, off] = kstack[:, 0].to(kpool.dtype)
            vpool[:, bid, off] = vstack[:, 0].to(vpool.dtype)
        return
    row, pos, valid, _, _ = rows_of(block_rows[0])
    dev = row.device
    L = kstacks[0].shape[0]
    nb = (S - 1) // bs + 1                             # the bucket's blocks
    seg = pos // bs

    def need(x):                       # per-block amax of the valid rows
        vl, sg = _to(valid, x.device), _to(seg, x.device)
        rows = torch.where(vl, _row_absmax(x, (2, 3)), 0.0)      # [L, S]
        return torch.zeros((L, nb), dtype=torch.float32, device=x.device) \
            .scatter_reduce(1, sg[None].expand(L, S), rows, reduce="amax")

    amax = _fold_amax([torch.stack([need(ks[:, 0]), need(vs[:, 0])], -1)
                       * _INV127 for ks, vs in zip(kstacks, vstacks)])
    # a segment without valid rows names the null block, a no-op max there
    cand = torch.arange(nb, device=dev)
    bids = torch.where(cand * bs < plen, row[torch.clamp_max(cand, maxb - 1)],
                       torch.zeros_like(cand))
    s_fin = torch.clamp_min(torch.maximum(scales[0][:, bids], amax),
                            KV_QUANT_EPS)
    for sc in _distinct(scales):
        b = _to(bids, sc.device)
        sc[:, b] = torch.maximum(sc[:, b], _to(s_fin, sc.device))
    s_row = s_fin[:, seg]                                        # [L, S, 2]
    for kpool, vpool, kstack, vstack, brow in zip(
            kpools, vpools, kstacks, vstacks, block_rows):
        _, _, _, bid, off = rows_of(brow)
        sr = _to(s_row, kpool.device)
        kpool[:, bid, off] = _quant_rows(kstack[:, 0], sr[..., 0, None, None])
        vpool[:, bid, off] = _quant_rows(vstack[:, 0], sr[..., 1, None, None])


def copy_pool_block(kpool, vpool, src, dst, scales=None):
    """Copy block `src`'s rows to block `dst` across every layer plane, IN
    PLACE: the engine's copy-on-write promotion. With `scales` (int8
    pools) the block's per-layer K/V scale rows ride along: quantized rows
    without their grid would dequantize on the destination's stale
    scale."""
    kpool[:, dst] = kpool[:, src]
    vpool[:, dst] = vpool[:, src]
    if scales is not None:
        scales[:, dst] = scales[:, src]


def export_pool_block_shards(kpools, vpools, src, scale_shards=None):
    """Copy block `src`'s rows out of head-sharded pools, one shard after
    another: `(k rows, v rows)`, each a list of `[layers, block_size,
    heads / mp, head_dim]` tensors in mesh order on the shards' devices,
    plus under int8 pools the block's `[layers, 2]` scale rows (the
    replicated grid, read from the first shard's replica). Copies, never
    views: the caller releases `src` at once. The block id is a host int,
    so the read uploads no index (an upload from pageable memory would
    wait on the stream behind a step in flight)."""
    src = int(src)
    ks = [kp[:, src].clone() for kp in kpools]
    vs = [vp[:, src].clone() for vp in vpools]
    if scale_shards is None:
        return ks, vs
    return ks, vs, scale_shards[0][:, src].clone()


def ingest_pool_block_shards(kpools, vpools, kblocks, vblocks, dst,
                             scale_shards=None, scale_row=None):
    """Write exported rows into block `dst` of head-sharded pools IN
    PLACE: shard i's rows land in shard i's pools, on that shard's device
    (a copy across devices when the payload came from another card).
    Under int8 pools the `[layers, 2]` scale row lands in every distinct
    scale replica, so each shard dequantizes on the exported grid."""
    dst = int(dst)
    for kp, vp, kb, vb in zip(kpools, vpools, kblocks, vblocks):
        kp[:, dst] = kb
        vp[:, dst] = vb
    if scale_shards is not None:
        for sc in _distinct(scale_shards):
            sc[:, dst] = scale_row


def export_pool_block(kpool, vpool, src, scales=None):
    """Copy block `src`'s rows out of one device's pools: the one-shard
    `export_pool_block_shards`. Returns `(k rows, v rows)`, each
    `[layers, block_size, heads, head_dim]`, plus the block's `[layers,
    2]` scale rows under int8 pools, as JAX's `export_pool_block`."""
    out = export_pool_block_shards(
        [kpool], [vpool], src, None if scales is None else [scales])
    return (out[0][0], out[1][0]) + tuple(out[2:])


def ingest_pool_block(kpool, vpool, kblock, vblock, dst, scales=None,
                      scale_row=None):
    """Write one exported block into block `dst` of one device's pools, in
    place (the one-shard `ingest_pool_block_shards`). Returns the pools
    (and the scales under int8), as JAX's `ingest_pool_block` returns its
    updated arrays."""
    ingest_pool_block_shards([kpool], [vpool], [kblock], [vblock], dst,
                             None if scales is None else [scales],
                             scale_row)
    if scales is None:
        return kpool, vpool
    return kpool, vpool, scales


def dense_gather_reference(kpool, vpool, layer, block_row, length):
    """Parity probe: one slot's first `length` cached k/v rows reassembled
    from the pools as numpy `[length, heads, head_dim]` arrays."""
    kp = kpool[layer].detach().cpu()
    vp = vpool[layer].detach().cpu()
    row = np.asarray(block_row.detach().cpu() if torch.is_tensor(block_row)
                     else block_row)
    bs = kp.shape[1]
    pos = np.arange(int(length))
    bids = torch.from_numpy(row[pos // bs].astype(np.int64))
    offs = torch.from_numpy(pos % bs)
    return kp[bids, offs].float().numpy(), vp[bids, offs].float().numpy()
