"""The split walk of `csrc/paged_split.cuh` at one row, as the decode
kernels run it (B3 on bf16 pools, B5a on int8 pools), emulated in plain
torch with no compiler, against the plain versions and against jitted JAX.

The kernel cuts each slot's keys `0..pos` into ranges of `RANGE_KEYS`
keys. One CTA a (range, head, slot) reads the key at `pos` from knew/vnew
and older keys from the pool, takes its range's max m_r, p = exp(s - m_r),
l_r = sum p, and acc_r = sum p v with p rounded to the V dtype (fp pools)
or per block times the V scale (int8; logits (q.k) * scale * ks, p not
rounded); a second launch combines the ranges in range order: out =
sum_r e^(m_r - M) acc_r / max(sum_r e^(m_r - M) l_r, 1e-30), cast once.
The range-0 CTA writes the new row into the pool in place and no CTA
reads it back. `decode_split_walk` repeats that, range by range.

Held at f32 (and int8 codes with f32 q) within 1e-5 of the plain versions
and of jitted JAX `paged_attention_step(backend="dense")`: the split
changes only the order of fp32 sums. At bf16 (and int8 with bf16 q,
whose output is cast to bf16) within the smoke's bf16 tolerance, 2e-2: p
is rounded to bf16 against its range's max, not the walk's running max.
The decode contract holds pools bit for bit everywhere, the null block 0
included: the case's one idle lane is the only writer there. Under jax
0.9.0 the JAX Pallas decode cannot run on the CPU (ROADMAP Queue C 1), so
JAX's dense step is the reference.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.paged_decode import (RANGE_KEYS,
                                               paged_decode_attention,
                                               paged_decode_int8_plain,
                                               paged_decode_plain,
                                               split_ranges, split_scratch)

L, H, D = 2, 2, 16
LAYER = 1
MAX_KEYS = 3 * RANGE_KEYS              # three ranges a full table
KINDS = ("float32", "bfloat16", "int8", "int8-bfloat16")
TOL = {"float32": 1e-5, "int8": 1e-5, "bfloat16": 2e-2,
       "int8-bfloat16": 2e-2}


def decode_split_walk(q, knew, vnew, kpool, vpool, layer, tables, positions,
                      kv_scales=None):
    """The kernel's split walk at one row in plain torch: the range-0
    CTA's in-place write, then per slot each range's (m_r, l_r, acc_r)
    from the keys the CTA copies, combined in range order. q, knew, vnew
    `[slots, 1, heads, D]`; returns out in q's dtype."""
    slots, _, heads, d = q.shape
    bs = kpool.shape[2]
    int8 = kv_scales is not None
    scale = 1.0 / math.sqrt(d)
    for s in range(slots):                 # the range-0 CTA's write
        pos = int(positions[s])
        bid = int(tables[s, pos // bs])
        kpool[layer, bid, pos % bs] = knew[s, 0]
        vpool[layer, bid, pos % bs] = vnew[s, 0]
    qf = q[:, 0].float()
    out = torch.empty((slots, heads, d), dtype=torch.float32)
    for s in range(slots):
        pos = int(positions[s])
        parts = []
        for r in range(pos // RANGE_KEYS + 1):
            t = torch.arange(r * RANGE_KEYS,
                             min((r + 1) * RANGE_KEYS, pos + 1))
            own = (t == pos)[:, None, None]  # the new row, from knew/vnew
            bid = tables[s, t // bs].long()
            keys = torch.where(own, knew[s, :1],
                               kpool[layer, bid, t % bs]).float()
            vals = torch.where(own, vnew[s, :1],
                               vpool[layer, bid, t % bs]).float()
            logits = torch.einsum("hd,nhd->hn", qf[s], keys) * scale
            if int8:
                logits = logits * kv_scales[bid, 0]
            mx = logits.amax(-1, keepdim=True)
            p = torch.exp(logits - mx)
            l_r = p.sum(-1, keepdim=True)
            if int8:                       # per block, times its V scale
                blk = t // bs
                acc = sum(torch.einsum("hn,nhd->hd", p[:, blk == j],
                                       vals[blk == j])
                          * kv_scales[int(tables[s, j]), 1]
                          for j in torch.unique(blk).tolist())
            else:
                acc = torch.einsum("hn,nhd->hd", p.to(vpool.dtype).float(),
                                   vals)
            parts.append((mx, l_r, acc))
        big = torch.stack([m for m, _, _ in parts]).amax(0)
        l_sum = sum(torch.exp(m - big) * l for m, l, _ in parts)
        a_sum = sum(torch.exp(m - big) * a for m, _, a in parts)
        out[s] = a_sum / torch.clamp_min(l_sum, 1e-30)
    return out[:, None].to(q.dtype)


POSITIONS = [0, RANGE_KEYS - 1, RANGE_KEYS, 2 * RANGE_KEYS - 1,
             2 * RANGE_KEYS, MAX_KEYS - 1, 300, 10]
SHARER, SHARED = 6, 5                  # slot 6 reads slot 5's first range


def decode_case(bs, seed):
    """Eight slots over tables of MAX_KEYS keys: an idle lane (position 0,
    null table); positions 127, 128, 255 and 256 at the range edges (128
    and 256 open a range of one key, the new one); position MAX_KEYS - 1,
    the table's last; a slot reading that one's first RANGE_KEYS keys
    read-only; a short context. Returns numpy inputs (f32)."""
    rng = np.random.RandomState(seed)
    maxb = MAX_KEYS // bs
    pos = np.array(POSITIONS, np.int32)
    slots = len(pos)
    tables = np.zeros((slots, maxb), np.int32)
    nxt = 1
    for s in range(1, slots):
        nb = pos[s] // bs + 1
        start = 0
        if s == SHARER:
            start = RANGE_KEYS // bs
            tables[s, :start] = tables[SHARED, :start]
        tables[s, start:nb] = np.arange(nxt, nxt + nb - start)
        nxt += nb - start
    kpool = rng.randn(L, nxt, bs, H, D).astype(np.float32)
    vpool = rng.randn(L, nxt, bs, H, D).astype(np.float32)
    q, k, v = (rng.randn(slots, 1, H, D).astype(np.float32)
               for _ in range(3))
    return [q, k, v, kpool, vpool, tables, pos]


def _quantized(kpool, vpool, rng):
    """int8 pools of the case's rows on per-block grids 0.7-1.3x
    absmax/127, and the scales [L, num_blocks, 2]."""
    x = np.stack([kpool, vpool])
    amax = np.abs(x).max(axis=(3, 4, 5))
    scales = (amax / 127 * rng.uniform(0.7, 1.3, amax.shape)) \
        .astype(np.float32)
    codes = np.clip(np.round(x / scales[..., None, None, None]), -127, 127)
    return (codes[0].astype(np.int8), codes[1].astype(np.int8),
            np.moveaxis(scales, 0, -1).copy())


def torch_case(bs, kind, seed):
    """The case as torch tensors for `kind` ("float32", "bfloat16": pools
    and q in that dtype; "int8" / "int8-bfloat16": int8 pools, q in f32 /
    bf16, the new row quantized on write in plain torch first, as the
    engine's op layer does). Returns (q, knew, vnew, kpool, vpool, scales
    or None, tables, positions) and the numpy case (raw rows, for JAX)."""
    args = decode_case(bs, seed)
    q, k, v, kpool, vpool, tables, pos = args
    int8 = kind.startswith("int8")
    scales = None
    if int8:
        kpool, vpool, scales = _quantized(kpool, vpool,
                                          np.random.RandomState(seed + 1))
        args[3:5] = kpool, vpool
        args.insert(5, scales)
    dt = torch.bfloat16 if kind.endswith("bfloat16") else torch.float32
    qt = torch.from_numpy(q).to(dt)
    kt, vt = (torch.from_numpy(a).to(torch.float32 if int8 else dt)
              for a in (k, v))
    # copies: the quant-on-write and the walk update these in place, and
    # JAX must see the case as it was made
    kp, vp = torch.from_numpy(kpool.copy()), torch.from_numpy(vpool.copy())
    if not int8:
        kp, vp = kp.to(dt), vp.to(dt)
    tb, ps = torch.from_numpy(tables), torch.from_numpy(pos)
    sc = None
    if int8:
        sc = torch.from_numpy(scales.copy())
        kq, vq = tpa._quant_write_decode(kp, vp, sc, kt, vt, tb, ps, LAYER)
        kt, vt = kq[:, None].contiguous(), vq[:, None].contiguous()
    return (qt, kt, vt, kp, vp, sc, tb, ps), args


def _run_both(c):
    """The plain version and the emulation on clones of the same pools:
    (plain out, split out, pools bit-identical everywhere)."""
    q, kn, vn, kp, vp, sc, tb, ps = c
    k0, v0, k1, v1 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    if sc is None:
        ref = paged_decode_plain(q, kn, vn, k0, v0, LAYER, tb, ps)
    else:
        ref = paged_decode_int8_plain(q, kn, vn, k0, v0, sc[LAYER], LAYER,
                                      tb, ps)
    got = decode_split_walk(q, kn, vn, k1, v1, LAYER, tb, ps,
                            None if sc is None else sc[LAYER])
    pools = torch.equal(k0, k1) and torch.equal(v0, v1)
    return ref, got, pools


@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_the_decode_case_walks_what_the_kernel_must(bs):
    """The case spreads over the ranges the docstring names at every block
    size: a full table is three ranges; slots 1-4 sit on the range edges
    (2 and 4 open a range that holds only the new key); slot 5 ends at
    the table's last key; slot 6 shares slot 5's first range and writes a
    block of its own; slot 0 is an idle lane."""
    _, _, _, _, _, tables, pos = decode_case(bs, 0)
    assert split_ranges(tables.shape[1], bs) == 3
    assert [int(p) // RANGE_KEYS + 1 for p in pos[1:5]] == [1, 2, 2, 3]
    assert [int(p) % RANGE_KEYS for p in pos[1:5]] == [RANGE_KEYS - 1, 0,
                                                       RANGE_KEYS - 1, 0]
    assert pos[5] == MAX_KEYS - 1 == tables.shape[1] * bs - 1
    n = RANGE_KEYS // bs
    assert np.array_equal(tables[SHARER, :n], tables[SHARED, :n])
    assert tables[SHARER, pos[SHARER] // bs] not in tables[SHARED]
    assert pos[0] == 0 and not tables[0].any()
    live = [tables[s, :pos[s] // bs + 1] for s in range(1, len(pos))]
    assert all(t.all() for t in live)      # no live lane reads block 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_decode_split_walk_matches_the_plain_version(bs, kind):
    c, _ = torch_case(bs, kind, 13 * bs + KINDS.index(kind))
    ref, got, pools = _run_both(c)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert float((got.float() - ref.float()).abs().max()) <= TOL[kind]
    assert pools


def _jax_step(kind):
    def fn(q, k, v, kp, vp, *rest):
        if kind == "bfloat16":
            q, k, v, kp, vp = (a.astype(jnp.bfloat16)
                               for a in (q, k, v, kp, vp))
        if kind == "int8":
            sc, bt, pos = rest
            res = jpa.paged_attention_step(q, k, v, kp, vp, LAYER, bt, pos,
                                           backend="dense", scales=sc)
        else:
            bt, pos = rest
            res = jpa.paged_attention_step(q, k, v, kp, vp, LAYER, bt, pos,
                                           backend="dense")
        return tuple(getattr(o, "_array", o).astype(jnp.float32)
                     if i == 0 else getattr(o, "_array", o)
                     for i, o in enumerate(res))
    return jax.jit(fn)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_decode_split_walk_matches_jitted_jax(bs, kind):
    """The emulation against JAX's dense decode step (fp), or its
    quant-on-write and dense int8 step (int8, f32 q), on the same seeded
    inputs: outputs of every slot, and the pools (codes) bit for bit."""
    c, args = torch_case(bs, kind, 13 * bs + KINDS.index(kind))
    jout, jk, jv = _jax_step(kind)(*args)[:3]
    q, kn, vn, kp, vp, sc, tb, ps = c
    got = decode_split_walk(q, kn, vn, kp, vp, LAYER, tb, ps,
                            None if sc is None else sc[LAYER])
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jout),
                               rtol=0, atol=TOL[kind])
    for mine, theirs in ((kp, jk), (vp, jv)):
        assert np.array_equal(mine.float().numpy(),
                              np.asarray(theirs.astype(jnp.float32)))


@pytest.mark.parametrize("W", [1, 5])
def test_split_scratch_shapes_and_alignment(W):
    """The wrappers' scratch for the split walk: fp32 partials [slots,
    heads, ranges, W, D] and [slots, heads, ranges, W, 2] (W 1 at decode),
    and a refusal, naming the tensor, of a base that is not 16-byte
    aligned (the walk copies 16 bytes at a time)."""
    slots, heads, d, bs, maxb = 3, 2, 64, 16, 20
    q = torch.zeros((slots, W, heads, d), dtype=torch.bfloat16)
    pool = torch.zeros((2, 8, bs, heads, d), dtype=torch.bfloat16)
    acc, ml = split_scratch("fn", q, q, q, pool, pool, maxb)
    nr = split_ranges(maxb, bs)
    assert nr == 3
    assert acc.shape == (slots, heads, nr, W, d) and acc.dtype == torch.float32
    assert ml.shape == (slots, heads, nr, W, 2) and ml.dtype == torch.float32
    flat = torch.zeros(pool.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(pool.shape)
    with pytest.raises(ValueError, match="fn: vpool must be 16-byte aligned"):
        split_scratch("fn", q, q, q, pool, shifted, maxb)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor takes the plain version and launches nothing: the
    wrapper's choice rests on the tensor's device alone."""
    c, _ = torch_case(16, "bfloat16", 3)
    q, kn, vn, kp, vp, _, tb, ps = c
    launches = paged_decode_attention.launches
    plain = paged_decode_attention.plain_calls
    out = paged_decode_attention(q, kn, vn, kp.clone(), vp.clone(), LAYER,
                                 tb, ps)
    assert paged_decode_attention.launches == launches
    assert paged_decode_attention.plain_calls == plain + 1
    assert out.shape == q.shape and out.dtype == q.dtype
