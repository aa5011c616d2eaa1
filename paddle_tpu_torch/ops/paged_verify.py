"""Paged speculative-verify attention: the CUDA kernel `csrc/paged_verify.cu`,
its int8 variant, and their plain PyTorch versions.

Counterpart of paddle_tpu/ops/pallas/paged_attention.py
`paged_verify_attention` (kernel bodies `_verify_kernel` and
`_verify_kernel_int8`); the plain versions are the ports of the dense path
`_dense_verify` and of the attention half of `_dense_verify_q` in
paddle_tpu/ops/paged_attention.py, which compute the same functions in the
same operation order.

One verify step for one layer over a fixed `[slots, W]` window (W = K+1:
the feed token, then up to K drafted tokens). Window row i of slot s sits at
absolute position `positions[s] + i` and is LIVE iff `i <= draft_lens[s]`:
a live row writes its k/v IN PLACE at `(table[min((pos+i)//bs,
max_blocks-1)], (pos+i) % bs)`, a dead row writes the null block 0 at
`(pos+i) % bs`. Every row then attends causally over the keys at or before
its own position. Idle lanes are (position 0, draft length 0, all-zero
table), as in decode. Outputs of dead rows are garbage the engine ignores.

`paged_verify_attention` (fp pools) and `paged_verify_attention_int8` (int8
pools with a per-block `[num_blocks, 2]` f32 K/V scale plane; the rows
arrive already quantized by the op layer) take the plain version for CPU
tensors and launch the kernel for CUDA tensors; they never fall back. Each
counts its launches in `.launches` and every call of its plain version, on
any device, in `.plain_calls`.

On bf16 and int8 pools the kernel is the split walk of
`csrc/paged_split.cuh`, which the decode kernels share at one row (see
ops/paged_decode.py: `RANGE_KEYS`, `split_ranges`, `split_scratch`). It
rounds p against its range's max where the plain version rounds against
the walk's running max, a difference of the order of one bf16 rounding of
p. f32 pools keep the first design, one CTA a (slot, head) over the whole
walk.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import cpp_extension
from .paged_decode import (_DTYPE_CODE, RANGE_KEYS, check_paged_args,
                           paged_walk, split_ranges, split_scratch)

__all__ = ["paged_verify_attention", "paged_verify_plain",
           "paged_verify_attention_int8", "paged_verify_int8_plain",
           "MAX_WINDOW", "RANGE_KEYS", "split_ranges"]

#: the widest window the kernels take (K <= 8 drafted tokens)
MAX_WINDOW = 9


def _window_writes(knew, vnew, kpool, vpool, layer, block_tables,
                   positions, draft_lens):
    """Land the window's rows IN PLACE (live rows through the table, dead
    rows in the null block); returns the rows' absolute positions
    `[slots, W]` (int64) and the tables as int64."""
    W = knew.shape[1]
    bs = kpool.shape[2]
    maxb = block_tables.shape[1]
    bt = block_tables.long()
    ar = torch.arange(W, device=knew.device)
    wpos = positions.long()[:, None] + ar[None, :]
    live = ar[None, :] <= draft_lens.long()[:, None]
    # the table index is clamped so a dead row past the table stays in
    # bounds before the where() routes it to the null block
    bid = torch.where(live, bt.gather(1, torch.clamp_max(wpos // bs,
                                                         maxb - 1)),
                      torch.zeros_like(wpos))
    off = wpos % bs
    kpool[layer, bid, off] = knew.to(kpool.dtype)
    vpool[layer, bid, off] = vnew.to(vpool.dtype)
    return wpos, bt


def _hw_blocks(positions, draft_lens, bs):
    """The batch's high-water block count: the walk of `_dense_verify`."""
    return int((positions.long() + draft_lens.long()).max()) // bs + 1


def paged_verify_plain(q, knew, vnew, kpool, vpool, layer, block_tables,
                       positions, draft_lens):
    """Plain PyTorch version of the fp kernel: the port of `_dense_verify`.
    q/knew/vnew `[slots, W, heads, D]` in the pool dtype; pools updated IN
    PLACE. Per-block online softmax over the batch's high-water block
    count; q rounded to the pool dtype before QK, probabilities to the V
    dtype before PV, fp32 logits/state/accumulation, one cast at the end.
    Returns `out [slots, W, heads, D]` in q's dtype."""
    paged_verify_attention.plain_calls += 1
    wpos, bt = _window_writes(knew, vnew, kpool, vpool, layer, block_tables,
                              positions, draft_lens)
    out = paged_walk(q.to(kpool.dtype).float(), kpool, vpool, layer, bt,
                     wpos, _hw_blocks(positions, draft_lens,
                                      kpool.shape[2]))
    return out.to(q.dtype)                                 # cast ONCE


def paged_verify_int8_plain(q, knew, vnew, kpool, vpool, kv_scales, layer,
                            block_tables, positions, draft_lens):
    """Plain PyTorch version of the int8 kernel: the attention half of
    `_dense_verify_q`. knew/vnew `[slots, W, heads, D]` are int8 codes
    already on their blocks' grids; kv_scales is this layer's
    `[num_blocks, 2]` f32 plane. q stays f32, codes are cast to f32,
    logits `(q.k) * s * ks`, `acc * alpha + (p.v) * vs` per block, P not
    rounded. Returns `out [slots, W, heads, D]` in q's dtype."""
    paged_verify_attention_int8.plain_calls += 1
    wpos, bt = _window_writes(knew, vnew, kpool, vpool, layer, block_tables,
                              positions, draft_lens)
    out = paged_walk(q.float(), kpool, vpool, layer, bt, wpos,
                     _hw_blocks(positions, draft_lens, kpool.shape[2]),
                     kv_scales)
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _bind(name):
    fn = getattr(cpp_extension.load("paged_verify"), name)
    P, I = ctypes.c_void_p, ctypes.c_int
    n_ptr = 11 if name == "paged_verify" else 12
    fn.argtypes = [P] * n_ptr + [I] * 10 + [ctypes.c_float, P]
    fn.restype = I
    return fn


def _launch(wrapper, name, q, knew, vnew, kpool, vpool, kv_scales, layer,
            block_tables, positions, draft_lens):
    check_paged_args(wrapper.__name__, q, knew, vnew, kpool, vpool, layer,
                     block_tables, positions, kv_scales,
                     rows=(2, MAX_WINDOW),
                     extra=(("draft_lens", draft_lens),))
    slots, W, heads, d = q.shape
    L, nb, bs = kpool.shape[:3]
    maxb = block_tables.shape[1]
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if kpool.dtype != torch.float32:       # the split walk (bf16, int8)
        part_acc, part_ml = split_scratch(wrapper.__name__, q, knew, vnew,
                                          kpool, vpool, maxb)
    fn = _bind(name)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [q, knew, vnew, kpool, vpool]
    if kv_scales is not None:
        ptrs.append(kv_scales)
    ptrs += [block_tables, positions, draft_lens, out]
    wrapper.launches += 1
    err = fn(*(t.data_ptr() for t in ptrs),
             *(None if t is None else t.data_ptr()
               for t in (part_acc, part_ml)),
             _DTYPE_CODE[q.dtype], slots, W, heads, d, int(layer), nb, bs,
             maxb, RANGE_KEYS, 1.0 / math.sqrt(d), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def paged_verify_attention(q, knew, vnew, kpool, vpool, layer, block_tables,
                           positions, draft_lens):
    """One speculative verify step for one layer over the global paged
    pools.

    q/knew/vnew: `[slots, W, heads, D]`, W = K+1 >= 2; kpool/vpool
    `[layers, num_blocks, block_size, heads, D]`, updated IN PLACE;
    block_tables `[slots, max_blocks]`, positions `[slots]` (window row 0's
    absolute position) and draft_lens `[slots]` (rows `0..draft_len` are
    live), all int32. Returns `out [slots, W, heads, D]`.

    CPU tensors take `paged_verify_plain`. CUDA tensors launch the kernel:
    W <= 9, D in {64, 128}, block_size in {8, 16, 32, 64}, q/knew/vnew in
    the pool dtype (float32 or bfloat16), everything contiguous, and at
    bfloat16 q, the new rows and the pools 16-byte aligned; anything else
    raises."""
    if q.device.type == "cpu":
        return paged_verify_plain(q, knew, vnew, kpool, vpool, layer,
                                  block_tables, positions, draft_lens)
    return _launch(paged_verify_attention, "paged_verify", q, knew, vnew,
                   kpool, vpool, None, layer, block_tables, positions,
                   draft_lens)


paged_verify_attention.launches = 0
paged_verify_attention.plain_calls = 0


def paged_verify_attention_int8(q, knew, vnew, kpool, vpool, kv_scales,
                                layer, block_tables, positions, draft_lens):
    """`paged_verify_attention` over int8 pools: knew/vnew are the window's
    rows already quantized onto their blocks' grids (int8), kv_scales this
    layer's `[num_blocks, 2]` f32 K/V scale plane; q (float32 or bfloat16)
    stays f32 inside, out is in q's dtype. CPU tensors take
    `paged_verify_int8_plain`; CUDA tensors launch the kernel (q, the new
    rows and the pools 16-byte aligned) or raise."""
    if q.device.type == "cpu":
        return paged_verify_int8_plain(q, knew, vnew, kpool, vpool,
                                       kv_scales, layer, block_tables,
                                       positions, draft_lens)
    return _launch(paged_verify_attention_int8, "paged_verify_int8", q, knew,
                   vnew, kpool, vpool, kv_scales, layer, block_tables,
                   positions, draft_lens)


paged_verify_attention_int8.launches = 0
paged_verify_attention_int8.plain_calls = 0
