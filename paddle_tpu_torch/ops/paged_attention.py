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
- `paged_prefill_chunk`: one chunk of chunked prefill for one slot. The JAX
  package runs it outside Pallas, so it stays plain PyTorch here.
- `copy_pool_block`: the engine's copy-on-write step.
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
`_verify_kernel_int8`), which dequantize per streamed block. The
tensor-parallel absmax fold (`_fold_amax`) is the identity on one device
and is not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .paged_decode import (_BLOCK_SIZES, _HEAD_DIMS, paged_decode_attention,
                           paged_decode_attention_int8,
                           paged_decode_int8_plain, paged_decode_plain)
from .paged_verify import (paged_verify_attention,
                           paged_verify_attention_int8,
                           paged_verify_int8_plain, paged_verify_plain)

__all__ = ["PAGED_BACKENDS", "resolve_backend", "paged_attention_step",
           "paged_verify_window",
           "paged_prefill_chunk", "copy_pool_block",
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


def _grow_blocks(kpool, vpool, scales, layer, bids, amax):
    """Grow the grids of blocks `bids` (any shape) to cover `amax`
    (`bids.shape + (2,)`, already divided by 127), requantize their rows
    IN PLACE and store the new scale rows; returns the new scales."""
    s_old = scales[layer, bids]
    s_new = torch.clamp_min(torch.maximum(s_old, amax), KV_QUANT_EPS)
    fac = s_old / s_new
    tail = (None,) * 3                       # over [bs, heads, D]
    kpool[layer, bids] = _requant_grow(kpool[layer, bids],
                                       fac[(..., 0) + tail])
    vpool[layer, bids] = _requant_grow(vpool[layer, bids],
                                       fac[(..., 1) + tail])
    scales[layer, bids] = s_new
    return s_new


def _row_absmax(x, dims):
    return x.float().abs().amax(dim=dims)


def _quant_write_decode(kpool, vpool, scales, k, v, block_tables, positions,
                        layer):
    """Quant-on-write bookkeeping for one decode row per slot (the port of
    `_quant_write_decode`): grow + requantize each slot's write block and
    update its scale row, IN PLACE. Returns the quantized new rows
    `(kq, vq)`, `[slots, heads, D]` int8, not yet written (the kernel
    lands them)."""
    bs = kpool.shape[2]
    pos = positions.long()
    bid_w = block_tables.long().gather(1, (pos // bs)[:, None])[:, 0]
    amax = torch.stack([_row_absmax(k[:, 0], (1, 2)),
                        _row_absmax(v[:, 0], (1, 2))], -1) * _INV127
    s_new = _grow_blocks(kpool, vpool, scales, layer, bid_w, amax)
    return (_quant_rows(k[:, 0], s_new[:, 0, None, None]),
            _quant_rows(v[:, 0], s_new[:, 1, None, None]))


def _quant_write_window(kpool, vpool, scales, k, v, block_tables, positions,
                        draft_lens, layer):
    """Window edition (the port of `_quant_write_window`): W contiguous
    write positions per slot span a fixed number of candidate table slots,
    `(W - 1) // bs + 2`; dead rows (i > draft_len) stay out of the absmax.
    Candidates past the table route to the null block, so a clamped index
    never races the real last block's grid. Returns `(kq, vq)`,
    `[slots, W, heads, D]` int8."""
    B, W = k.shape[:2]
    bs = kpool.shape[2]
    maxb = block_tables.shape[1]
    dev = k.device
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
        rows = torch.where(live, _row_absmax(x, (2, 3)), 0.0)
        return torch.zeros((B, nb), dtype=torch.float32, device=dev) \
            .scatter_reduce(1, seg, rows, reduce="amax")

    amax = torch.stack([need(k), need(v)], -1) * _INV127   # [B, nb, 2]
    s_new = _grow_blocks(kpool, vpool, scales, layer, bids, amax)
    s_row = s_new.gather(1, seg[..., None].expand(B, W, 2))
    return (_quant_rows(k, s_row[..., 0, None, None]),
            _quant_rows(v, s_row[..., 1, None, None]))


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
    dense = _dense(paged_attention_step, backend)
    if scales is None:
        return (paged_decode_plain if dense else paged_decode_attention)(
            q.contiguous(), k.contiguous(), v.contiguous(), kpool, vpool,
            layer, block_tables, positions, scale)
    if scale is not None:
        raise ValueError("int8 pools take the default softmax scale")
    kq, vq = _quant_write_decode(kpool, vpool, scales, k, v, block_tables,
                                 positions, layer)
    return (paged_decode_int8_plain if dense
            else paged_decode_attention_int8)(
        q.contiguous(), kq[:, None].contiguous(), vq[:, None].contiguous(),
        kpool, vpool, scales[layer], layer, block_tables, positions)


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
    dense = _dense(paged_verify_window, backend)
    if scales is None:
        return (paged_verify_plain if dense else paged_verify_attention)(
            q.contiguous(), k.contiguous(), v.contiguous(), kpool, vpool,
            layer, block_tables, positions, draft_lens)
    kq, vq = _quant_write_window(kpool, vpool, scales, k, v, block_tables,
                                 positions, draft_lens, layer)
    return (paged_verify_int8_plain if dense
            else paged_verify_attention_int8)(
        q.contiguous(), kq, vq, kpool, vpool, scales[layer], layer,
        block_tables, positions, draft_lens)


paged_verify_window.dense_calls = 0


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
    if scales is not None:
        if scale is not None:
            raise ValueError("int8 pools take the default softmax scale")
        return _prefill_chunk_int8(q, k, v, kpool, vpool, scales, layer,
                                   block_row, start, plen)
    C, heads, d = q.shape[1], q.shape[2], q.shape[3]
    bs = kpool.shape[2]
    maxb = block_row.shape[0]
    dev = kpool.device
    row = block_row.long()
    pos = start + torch.arange(C, device=dev)
    valid = pos < plen
    bid = torch.where(valid, row[torch.clamp_max(pos // bs, maxb - 1)],
                      torch.zeros_like(pos))
    off = pos % bs
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


def _prefill_chunk_int8(q, k, v, kpool, vpool, scales, layer, block_row,
                        start, plen):
    """The int8 branch of `paged_prefill_chunk` (JAX `fnq`): a chunk may
    finish a block an earlier chunk started, so each candidate block the
    chunk spans grows its grid and requantizes (candidates without valid
    rows keep their scale: factor 1, exact; candidates past the table
    route to the null block); then the chunk's rows land quantized and
    the queries attend as the fp branch does, gathered and with one masked
    softmax, over dequantized keys: logits `(q.k) * s * ks`, probabilities
    not rounded, each key's `p * vs` before PV."""
    C, heads, d = q.shape[1], q.shape[2], q.shape[3]
    bs = kpool.shape[2]
    maxb = block_row.shape[0]
    dev = kpool.device
    row = block_row.long()
    nb = (C - 1) // bs + 2
    pos = start + torch.arange(C, device=dev)
    valid = pos < plen
    first = start // bs
    seg = torch.clamp(pos // bs - first, 0, nb - 1)
    cand = first + torch.arange(nb, device=dev)
    bids = torch.where(cand <= maxb - 1, row[torch.clamp_max(cand, maxb - 1)],
                       torch.zeros_like(cand))

    def need(x):
        rows = torch.where(valid, _row_absmax(x[0], (1, 2)), 0.0)
        return torch.zeros(nb, dtype=torch.float32, device=dev) \
            .scatter_reduce(0, seg, rows, reduce="amax")

    amax = torch.stack([need(k), need(v)], -1) * _INV127   # [nb, 2]
    s_new = _grow_blocks(kpool, vpool, scales, layer, bids, amax)
    s_row = s_new[seg]                                     # [C, 2]
    bid = torch.where(valid, row[torch.clamp_max(pos // bs, maxb - 1)],
                      torch.zeros_like(pos))
    off = pos % bs
    kpool[layer, bid, off] = _quant_rows(k[0], s_row[:, 0, None, None])
    vpool[layer, bid, off] = _quant_rows(v[0], s_row[:, 1, None, None])
    s = 1.0 / math.sqrt(d)
    end = min(start + C, plen)
    hw = max(end - 1, 0) // bs + 1
    blocks = row[:hw]
    keys = kpool[layer, blocks].reshape(hw * bs, heads, d).float()
    vals = vpool[layer, blocks].reshape(hw * bs, heads, d).float()
    ks = scales[layer, blocks, 0].repeat_interleave(bs)    # per key
    vs = scales[layer, blocks, 1].repeat_interleave(bs)
    logits = torch.einsum("chd,khd->hck", q[0].float(), keys) * s * ks
    allowed = torch.arange(hw * bs, device=dev)[None, :] <= pos[:, None]
    logits = torch.where(allowed[None], logits,
                         torch.full_like(logits, -1e30))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)                              # [heads, C, K]
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("hck,khd->hcd", p * vs, vals)
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out.transpose(0, 1)[None]                       # [1, C, heads, d]


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
