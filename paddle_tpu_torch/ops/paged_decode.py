"""Paged decode attention: the CUDA kernel `csrc/paged_decode.cu`, its int8
variant, and their plain PyTorch versions.

Counterpart of paddle_tpu/ops/pallas/paged_attention.py
`paged_decode_attention` (kernel bodies `_decode_kernel` and
`_decode_kernel_int8`); the plain versions are the ports of the dense paths
`_dense_step` and the attention half of `_dense_step_q` in
paddle_tpu/ops/paged_attention.py, which compute the same functions in the
same operation order.

One batched decode step for one layer: each slot writes its new k/v row
into the pools IN PLACE at `(block_tables[s, pos // bs], pos % bs)`, then
attends its query over keys `0..pos` through its block table with an fp32
online softmax. Idle lanes are (position 0, all-zero table): they write
row 0 of the null block 0 and attend only that row.

`paged_decode_attention` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors; it never falls back. It counts its
kernel launches in `paged_decode_attention.launches`, and every call of
the plain version, on any device, in `paged_decode_attention.plain_calls`.

`paged_decode_attention_int8` is the same step over int8 pools with a
per-block `[num_blocks, 2]` f32 K/V scale plane: the new rows arrive
already quantized (the op layer's quant-on-write), and the walk
dequantizes each block with its grid. It has its own counters.

On bf16 and int8 pools the kernel is the split walk of
`csrc/paged_split.cuh`, which the verify kernels share: each slot's keys
in ranges of `RANGE_KEYS`, one CTA a (range, head, slot) writing fp32
partials that a second launch combines in range order (`split_scratch`
allocates them, `split_ranges` ranges a table). It rounds p against its
range's max where the plain version rounds against the walk's running
max, a difference of the order of one bf16 rounding of p. f32 pools keep
the first design, one CTA a (slot, head) over the whole walk.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import cpp_extension

__all__ = ["paged_decode_attention", "paged_decode_plain",
           "paged_decode_attention_int8", "paged_decode_int8_plain",
           "RANGE_KEYS", "split_ranges"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_BLOCK_SIZES = (8, 16, 32, 64)
#: keys one CTA of the split walk (bf16 and int8 pools, decode and verify)
#: walks: `csrc/paged_split.cuh` kRangeKeys, which the launches check
RANGE_KEYS = 128


def paged_decode_plain(q, knew, vnew, kpool, vpool, layer, block_tables,
                       positions, scale=None):
    """Plain PyTorch version: the port of `_dense_step`. Per-block online
    softmax over the batch's high-water block count; q rounded to the pool
    dtype before QK, probabilities to the V dtype before PV, fp32
    logits/state/accumulation, one cast at the end. Updates the pools in
    place; returns `out [slots, 1, heads, D]` in q's dtype."""
    paged_decode_attention.plain_calls += 1
    B, _, heads, d = q.shape
    bs = kpool.shape[2]
    pos = positions.long()
    bt = block_tables.long()
    bid_w = bt.gather(1, (pos // bs)[:, None])[:, 0]
    off = pos % bs
    kpool[layer, bid_w, off] = knew[:, 0].to(kpool.dtype)
    vpool[layer, bid_w, off] = vnew[:, 0].to(vpool.dtype)
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q[:, 0].to(kpool.dtype).float()                   # [B, heads, d]
    hw_blocks = int(pos.max()) // bs + 1
    dev = q.device
    m = torch.full((B, heads, 1), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, heads, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, heads, d), dtype=torch.float32, device=dev)
    ar = torch.arange(bs, device=dev)
    for j in range(hw_blocks):
        bid = bt[:, j]
        keys = kpool[layer, bid].float()                   # [B, bs, heads, d]
        vals = vpool[layer, bid]
        logits = torch.einsum("bhd,bkhd->bhk", qf, keys) * s
        allowed = (j * bs + ar)[None, :] <= pos[:, None]
        logits = torch.where(allowed[:, None, :], logits,
                             torch.full_like(logits, -1e30))
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)                      # [B, heads, bs]
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhk,bkhd->bhd", p.to(vals.dtype).float(),
                          vals.float())
        acc = acc * alpha + pv
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)    # cast ONCE
    return out[:, None]


def paged_walk(qf, kpool, vpool, layer, block_tables, wpos, hw_blocks,
               kv_scales=None):
    """The per-block online softmax shared by the plain versions of the
    int8 decode and of both verify kernels: the ports of the `fori_loop`
    bodies of `_dense_verify`, `_dense_verify_q` and `_dense_step_q`.

    qf `[B, W, heads, D]` f32 queries; row w of slot b sees the keys at
    positions `<= wpos[b, w]` (int64 `[B, W]`) among blocks
    `0..hw_blocks-1` of its table (int64 `[B, max_blocks]`). fp pools:
    probabilities rounded to the V dtype before PV. int8 pools
    (`kv_scales`, this layer's `[num_blocks, 2]` f32 K/V grid): codes cast
    to f32, logits `(q.k) * s * ks`, probabilities not rounded, each
    block's `(p.v) * vs` added to the accumulator. Returns the normalized
    f32 output `[B, W, heads, D]`, with the default scale 1/sqrt(D)."""
    B, W, heads, d = qf.shape
    bs = kpool.shape[2]
    dev = qf.device
    s = 1.0 / math.sqrt(d)
    m = torch.full((B, heads, W, 1), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, heads, W, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, heads, W, d), dtype=torch.float32, device=dev)
    ar = torch.arange(bs, device=dev)
    for j in range(hw_blocks):
        bid = block_tables[:, j]
        keys = kpool[layer, bid].float()                   # [B, bs, heads, d]
        vals = vpool[layer, bid]
        logits = torch.einsum("bwhd,bkhd->bhwk", qf, keys) * s
        if kv_scales is not None:
            logits = logits * kv_scales[bid, 0][:, None, None, None]
        allowed = (j * bs + ar)[None, None, :] <= wpos[:, :, None]
        logits = torch.where(allowed[:, None], logits,
                             torch.full_like(logits, -1e30))
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)                      # [B, heads, W, bs]
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        if kv_scales is None:
            pv = torch.einsum("bhwk,bkhd->bhwd", p.to(vals.dtype).float(),
                              vals.float())
        else:
            pv = torch.einsum("bhwk,bkhd->bhwd", p, vals.float()) \
                * kv_scales[bid, 1][:, None, None, None]
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).transpose(1, 2)


def paged_decode_int8_plain(q, knew, vnew, kpool, vpool, kv_scales, layer,
                            block_tables, positions):
    """Plain PyTorch version of the int8 kernel: the attention half of
    `_dense_step_q`. knew/vnew `[slots, 1, heads, D]` are int8 codes
    already on their block's grid, written IN PLACE at
    `(table[pos // bs], pos % bs)`; kv_scales is this layer's
    `[num_blocks, 2]` f32 plane. q stays f32 (no rounding to the pool
    dtype); returns `out [slots, 1, heads, D]` in q's dtype."""
    paged_decode_attention_int8.plain_calls += 1
    bs = kpool.shape[2]
    pos = positions.long()
    bt = block_tables.long()
    bid_w = bt.gather(1, (pos // bs)[:, None])[:, 0]
    off = pos % bs
    kpool[layer, bid_w, off] = knew[:, 0]
    vpool[layer, bid_w, off] = vnew[:, 0]
    out = paged_walk(q.float(), kpool, vpool, layer, bt, pos[:, None],
                     int(pos.max()) // bs + 1, kv_scales)
    return out.to(q.dtype)                                 # cast ONCE


def check_paged_args(fn, q, knew, vnew, kpool, vpool, layer, block_tables,
                     positions, kv_scales=None, rows=(1, 1), extra=()):
    """Raise on anything a paged kernel (decode or verify, fp or int8)
    does not take: `fn` names it in the message, `rows` is the (least,
    most) window width, `extra` more named int32 `[slots]` tensors."""
    tensors = dict(q=q, knew=knew, vnew=vnew, kpool=kpool, vpool=vpool,
                   block_tables=block_tables, positions=positions,
                   **dict(extra))
    if kv_scales is not None:
        tensors["kv_scales"] = kv_scales
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} is on {t.device}, the kernel "
                             "needs every tensor on the card")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{fn}: q dtype {q.dtype} is not float32 or "
                         "bfloat16")
    pool_dtype = q.dtype if kv_scales is None else torch.int8
    for name in ("knew", "vnew", "kpool", "vpool"):
        if tensors[name].dtype != pool_dtype:
            raise ValueError(f"{fn}: {name} is {tensors[name].dtype}, the "
                             f"kernel needs {pool_dtype}")
    for name in ["block_tables", "positions"] + [n for n, _ in extra]:
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{fn}: {name} must be int32")
    slots, W, heads, d = q.shape
    L, nb, bs, ph, pd = kpool.shape
    if not rows[0] <= W <= rows[1]:
        raise ValueError(f"{fn}: {W} rows per slot; the kernel takes "
                         f"{rows[0]} to {rows[1]}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{fn}: head_dim {d} has no kernel (supported: "
                         f"{_HEAD_DIMS})")
    if bs not in _BLOCK_SIZES:
        raise ValueError(f"{fn}: block_size {bs} has no kernel (supported: "
                         f"{_BLOCK_SIZES})")
    if (ph, pd) != (heads, d) or vpool.shape != kpool.shape \
            or knew.shape != q.shape or vnew.shape != q.shape:
        raise ValueError(f"{fn}: q/knew/vnew {tuple(q.shape)} do not match "
                         f"the pools {tuple(kpool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != slots \
            or any(tensors[n].shape != (slots,)
                   for n in ["positions"] + [n for n, _ in extra]):
        raise ValueError(f"{fn}: block_tables must be [slots, max_blocks] "
                         "and positions [slots]")
    if kv_scales is not None and (kv_scales.dtype != torch.float32
                                  or kv_scales.shape != (nb, 2)):
        raise ValueError(f"{fn}: kv_scales must be this layer's f32 "
                         f"[num_blocks, 2] plane, got {kv_scales.dtype} "
                         f"{tuple(kv_scales.shape)}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"{fn}: layer {layer} outside the pools' {L} "
                         "layers")


def split_ranges(max_blocks, block_size):
    """The ranges of RANGE_KEYS keys the split walk cuts a table into: its
    grid's first dimension and the partials' third."""
    return -(-max_blocks * block_size // RANGE_KEYS)


def split_scratch(fn, q, knew, vnew, kpool, vpool, max_blocks):
    """The split walk's fp32 partials for `q [slots, W, heads, D]`:
    `(part_acc [slots, heads, ranges, W, D], part_ml [slots, heads,
    ranges, W, 2])`, W = 1 at decode. Raises first (`fn` names the caller)
    unless q, the new rows and the pools are 16-byte aligned: the walk
    copies 16 bytes at a time."""
    named = dict(q=q, knew=knew, vnew=vnew, kpool=kpool, vpool=vpool)
    bad = [n for n, t in named.items() if t.data_ptr() % 16]
    if bad:
        raise ValueError(f"{fn}: {', '.join(bad)} must be 16-byte aligned "
                         "(16-byte copies)")
    slots, W, heads, d = q.shape
    nr = split_ranges(max_blocks, kpool.shape[2])
    return (torch.empty((slots, heads, nr, W, d), dtype=torch.float32,
                        device=q.device),
            torch.empty((slots, heads, nr, W, 2), dtype=torch.float32,
                        device=q.device))


@functools.lru_cache(maxsize=None)
def _bind(name):
    fn = getattr(cpp_extension.load("paged_decode"), name)
    P, I = ctypes.c_void_p, ctypes.c_int
    n_ptr = 10 if name == "paged_decode" else 11
    fn.argtypes = [P] * n_ptr + [I] * 9 + [ctypes.c_float, P]
    fn.restype = I
    return fn


def _launch(wrapper, name, q, knew, vnew, kpool, vpool, kv_scales, layer,
            block_tables, positions, scale):
    check_paged_args(wrapper.__name__, q, knew, vnew, kpool, vpool, layer,
                     block_tables, positions, kv_scales)
    slots, _, heads, d = q.shape
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
    ptrs += [block_tables, positions, out]
    wrapper.launches += 1
    err = fn(*(t.data_ptr() for t in ptrs),
             *(None if t is None else t.data_ptr()
               for t in (part_acc, part_ml)),
             _DTYPE_CODE[q.dtype], slots, heads, d, int(layer), nb, bs, maxb,
             RANGE_KEYS, float(scale), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def paged_decode_attention(q, knew, vnew, kpool, vpool, layer,
                           block_tables, positions, scale=None):
    """One decode step for one layer over the global paged pools.

    q/knew/vnew: `[slots, 1, heads, D]`; kpool/vpool
    `[layers, num_blocks, block_size, heads, D]`, updated IN PLACE;
    block_tables `[slots, max_blocks]` int32; positions `[slots]` int32,
    each below `max_blocks * block_size`. Returns `out [slots, 1, heads, D]`.

    CPU tensors take `paged_decode_plain`. CUDA tensors launch the kernel:
    D in {64, 128}, block_size in {8, 16, 32, 64}, q/knew/vnew in the pool
    dtype (float32 or bfloat16), everything contiguous, and at bfloat16 q,
    the new rows and the pools 16-byte aligned; anything else raises."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, knew, vnew, kpool, vpool, layer,
                                  block_tables, positions, scale)
    return _launch(paged_decode_attention, "paged_decode", q, knew, vnew,
                   kpool, vpool, None, layer, block_tables, positions,
                   scale if scale is not None else 1.0 / math.sqrt(
                       q.shape[-1]))


paged_decode_attention.launches = 0
paged_decode_attention.plain_calls = 0


def paged_decode_attention_int8(q, knew, vnew, kpool, vpool, kv_scales,
                                layer, block_tables, positions):
    """One decode step for one layer over int8 pools.

    As `paged_decode_attention`, but kpool/vpool hold int8 codes,
    knew/vnew are the new rows already quantized onto their block's grid
    (int8), and kv_scales is this layer's `[num_blocks, 2]` f32 K/V scale
    plane, contiguous. q (float32 or bfloat16) stays f32 inside; out is in
    q's dtype. CPU tensors take `paged_decode_int8_plain`; CUDA tensors
    launch the kernel (q, the new rows and the pools 16-byte aligned) or
    raise."""
    if q.device.type == "cpu":
        return paged_decode_int8_plain(q, knew, vnew, kpool, vpool,
                                       kv_scales, layer, block_tables,
                                       positions)
    return _launch(paged_decode_attention_int8, "paged_decode_int8", q, knew,
                   vnew, kpool, vpool, kv_scales, layer, block_tables,
                   positions, 1.0 / math.sqrt(q.shape[-1]))


paged_decode_attention_int8.launches = 0
paged_decode_attention_int8.plain_calls = 0
