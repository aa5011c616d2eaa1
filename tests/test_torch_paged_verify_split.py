"""The split walk of `csrc/paged_verify.cu` (B4 on bf16 pools, B5b on int8
pools), emulated in plain torch with no compiler, against the plain
versions and against jitted JAX.

The kernel cuts each slot's keys `0..pos + dlen` into ranges of
`RANGE_KEYS` keys. One CTA a (range, head, slot) reads the window's own
keys (positions `pos..pos + dlen`) from knew/vnew and older keys from the
pool, takes its range's row max m_r, p = exp(s - m_r) (0 where the row may
not see the key), l_r = sum p, and acc_r = sum p v with p rounded to the V
dtype (fp pools) or per block times the V scale (int8); a second launch
combines the ranges in range order: out = sum_r e^(m_r - M) acc_r /
max(sum_r e^(m_r - M) l_r, 1e-30), cast once. The range-0 CTA writes the
window's rows into the pool. `split_walk` repeats that, range by range.

Held at f32 (and int8 codes with f32 q) within 1e-5 of the plain
versions and of jitted JAX `paged_verify_window(backend="dense")`: the
split changes only the order of fp32 sums. At bf16 within the smoke's
bf16 tolerance, 2e-2: p is rounded to bf16 against its range's max, not
the walk's running max. Pools are compared bitwise outside the null
block 0, outputs on live rows of live slots (as
tests/test_torch_paged_verify.py says why).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.paged_verify import (RANGE_KEYS,
                                               paged_verify_int8_plain,
                                               paged_verify_plain)

L, H, D = 2, 2, 16
LAYER = 1
MAX_KEYS = 3 * RANGE_KEYS              # three ranges a full table
TOL = {"float32": 1e-5, "int8": 1e-5, "bfloat16": 2e-2}


def split_walk(q, knew, vnew, kpool, vpool, layer, tables, positions,
               draft_lens, kv_scales=None):
    """The kernel's split walk in plain torch: the window's in-place
    writes, then per slot each range's (m_r, l_r, acc_r) from the keys the
    CTA copies, combined in range order. Returns out in q's dtype."""
    slots, W, heads, d = q.shape
    bs, maxb = kpool.shape[2], tables.shape[1]
    int8 = kv_scales is not None
    scale = 1.0 / math.sqrt(d)
    for s in range(slots):                 # the range-0 CTA's writes
        pos, dl = int(positions[s]), int(draft_lens[s])
        for i in range(W):
            wp = pos + i
            bid = int(tables[s, min(wp // bs, maxb - 1)]) if i <= dl else 0
            kpool[layer, bid, wp % bs] = knew[s, i]
            vpool[layer, bid, wp % bs] = vnew[s, i]
    qf = q.float()
    out = torch.empty(q.shape, dtype=torch.float32)
    for s in range(slots):
        pos = int(positions[s])
        last = pos + int(draft_lens[s])
        see = torch.clamp_max(pos + torch.arange(W), last)   # per row
        parts = []
        for r in range(last // RANGE_KEYS + 1):
            t = torch.arange(r * RANGE_KEYS,
                             min((r + 1) * RANGE_KEYS, last + 1))
            win = t >= pos
            bid = tables[s, t // bs].long()
            own = torch.clamp(t - pos, 0, W - 1)
            keys = torch.where(win[:, None, None], knew[s, own],
                               kpool[layer, bid, t % bs]).float()
            vals = torch.where(win[:, None, None], vnew[s, own],
                               vpool[layer, bid, t % bs]).float()
            logits = torch.einsum("whd,nhd->hwn", qf[s], keys) * scale
            if int8:
                logits = logits * kv_scales[bid, 0]
            allowed = t[None, :] <= see[:, None]             # [W, n]
            mx = torch.where(allowed, logits, torch.full_like(
                logits, -1e30)).amax(-1, keepdim=True)
            p = torch.where(allowed, torch.exp(logits - mx),
                            torch.zeros_like(logits))
            l_r = p.sum(-1, keepdim=True)
            if int8:                       # per block, times its V scale
                blk = t // bs
                acc = sum(torch.einsum("hwn,nhd->hwd", p[..., blk == j],
                                       vals[blk == j])
                          * kv_scales[int(tables[s, j]), 1]
                          for j in torch.unique(blk).tolist())
            else:
                acc = torch.einsum("hwn,nhd->hwd",
                                   p.to(vpool.dtype).float(), vals)
            parts.append((mx, l_r, acc))
        big = torch.stack([m for m, _, _ in parts]).amax(0)
        l_sum = sum(torch.exp(m - big) * l for m, l, _ in parts)
        a_sum = sum(torch.exp(m - big) * a for m, _, a in parts)
        out[s] = (a_sum / torch.clamp_min(l_sum, 1e-30)).transpose(0, 1)
    return out.to(q.dtype)


def split_case(bs, W, seed):
    """Seven slots over tables of MAX_KEYS keys: an idle lane; a window
    across the first range boundary; a last key opening a range of one
    key (one block); a window ending at the table's last position; a long
    context; a slot reading that one's first RANGE_KEYS keys read-only;
    a decode-like step (draft length 0, rows 1.. dead). Returns numpy
    inputs (f32) and the live mask."""
    rng = np.random.RandomState(seed)
    K = W - 1
    maxb = MAX_KEYS // bs
    pos = np.array([0, RANGE_KEYS - (K + 1) // 2,
                    2 * RANGE_KEYS - min(2, K), MAX_KEYS - 1 - K, 300, 200,
                    10], np.int32)
    dlen = np.array([0, K, min(2, K), K, min(3, K), K, 0], np.int32)
    slots = len(pos)
    tables = np.zeros((slots, maxb), np.int32)
    nxt = 1
    for s in range(1, slots):
        nb = (pos[s] + dlen[s]) // bs + 1
        start = 0
        if s == 5:                         # slot 3's first range
            start = RANGE_KEYS // bs
            tables[s, :start] = tables[3, :start]
        tables[s, start:nb] = np.arange(nxt, nxt + nb - start)
        nxt += nb - start
    kpool = rng.randn(L, nxt, bs, H, D).astype(np.float32)
    vpool = rng.randn(L, nxt, bs, H, D).astype(np.float32)
    q, k, v = (rng.randn(slots, W, H, D).astype(np.float32)
               for _ in range(3))
    live = np.arange(W)[None, :] <= dlen[:, None]
    live[0] = False
    return [q, k, v, kpool, vpool, tables, pos, dlen], live


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


def torch_case(bs, W, kind, seed):
    """The case as torch tensors for `kind` ("float32", "bfloat16": pools
    and q in that dtype; "int8": int8 pools, f32 q, the window quantized
    on write in plain torch first, as the kernel tests do). Returns
    (q, knew, vnew, kpool, vpool, scales or None, tables, positions,
    draft_lens), the live mask and the numpy case."""
    args, live = split_case(bs, W, seed)
    q, k, v, kpool, vpool, tables, pos, dlen = args
    scales = None
    if kind == "int8":
        kpool, vpool, scales = _quantized(kpool, vpool,
                                          np.random.RandomState(seed + 1))
        args[3:5] = kpool, vpool
        args.insert(5, scales)
    dt = torch.bfloat16 if kind == "bfloat16" else torch.float32
    qt, kt, vt = (torch.from_numpy(a).to(dt) for a in (q, k, v))
    kp, vp = torch.from_numpy(kpool), torch.from_numpy(vpool)
    if kind == "bfloat16":
        kp, vp = kp.to(dt), vp.to(dt)
    tb, ps, dl = (torch.from_numpy(a) for a in (tables, pos, dlen))
    sc = None
    if scales is not None:
        sc = torch.from_numpy(scales)
        kt, vt = tpa._quant_write_window(kp, vp, sc, kt, vt, tb, ps, dl,
                                         LAYER)
    return (qt, kt, vt, kp, vp, sc, tb, ps, dl), live, args


def _run_both(c):
    """The plain version and the emulation on clones of the same pools:
    (plain out, split out, pools bit-identical outside block 0)."""
    q, kn, vn, kp, vp, sc, tb, ps, dl = c
    k0, v0, k1, v1 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    if sc is None:
        ref = paged_verify_plain(q, kn, vn, k0, v0, LAYER, tb, ps, dl)
    else:
        ref = paged_verify_int8_plain(q, kn, vn, k0, v0, sc[LAYER], LAYER,
                                      tb, ps, dl)
    got = split_walk(q, kn, vn, k1, v1, LAYER, tb, ps, dl,
                     None if sc is None else sc[LAYER])
    pools = torch.equal(k0[:, 1:], k1[:, 1:]) and \
        torch.equal(v0[:, 1:], v1[:, 1:])
    return ref, got, pools


def test_the_case_walks_what_the_kernel_must():
    """The case spreads over the ranges the docstring names, at every
    block size: a full table is three ranges, slot 1's window straddles
    the first boundary, slot 2's last range holds one key, slot 3 ends at
    the table's last key, slot 5 shares slot 3's first range."""
    for bs in (8, 16, 32, 64):
        for W in (2, 5, 9):
            (_, _, _, _, _, tables, pos, dlen), _ = split_case(bs, W, 0)
            last = pos + dlen
            assert pos[1] < RANGE_KEYS <= last[1]
            assert last[2] == 2 * RANGE_KEYS
            assert last[3] == MAX_KEYS - 1 == tables.shape[1] * bs - 1
            assert last[3] // RANGE_KEYS + 1 == 3
            n = RANGE_KEYS // bs
            assert np.array_equal(tables[5, :n], tables[3, :n])
            assert (pos[0], dlen[0]) == (0, 0) and not tables[0].any()


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("W", [2, 5, 9])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_split_walk_matches_the_plain_version(bs, W, kind):
    c, live, _ = torch_case(bs, W, kind, 11 * bs + W)
    ref, got, pools = _run_both(c)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    err = (got.float() - ref.float())[torch.from_numpy(live)].abs().max()
    assert float(err) <= TOL[kind]
    assert pools


def _jax_verify(kind):
    def fn(q, k, v, kp, vp, *rest):
        if kind == "bfloat16":
            q, k, v, kp, vp = (a.astype(jnp.bfloat16)
                               for a in (q, k, v, kp, vp))
        if kind == "int8":
            sc, bt, pos, dlen = rest
            res = jpa.paged_verify_window(q, k, v, kp, vp, LAYER, bt, pos,
                                          dlen, backend="dense", scales=sc)
        else:
            bt, pos, dlen = rest
            res = jpa.paged_verify_window(q, k, v, kp, vp, LAYER, bt, pos,
                                          dlen, backend="dense")
        return tuple(getattr(o, "_array", o).astype(jnp.float32)
                     if i == 0 else getattr(o, "_array", o)
                     for i, o in enumerate(res))
    return jax.jit(fn)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("bs,W", [(8, 9), (16, 5), (64, 2)])
def test_split_walk_matches_jitted_jax(bs, W, kind):
    """The emulation against JAX's dense verify (fp), or its quant-on-write
    and dense int8 verify (int8), on the same seeded inputs."""
    c, live, args = torch_case(bs, W, kind, 11 * bs + W)
    jout = np.asarray(_jax_verify(kind)(*args)[0])
    q, kn, vn, kp, vp, sc, tb, ps, dl = c
    got = split_walk(q, kn, vn, kp, vp, LAYER, tb, ps, dl,
                     None if sc is None else sc[LAYER])
    np.testing.assert_allclose(got.float().numpy()[live], jout[live],
                               rtol=0, atol=TOL[kind])
