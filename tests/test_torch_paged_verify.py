"""The speculative verify op of the PyTorch port against the JAX package.

`paged_verify_window` on CPU tensors runs `paged_verify_plain` (what the
CUDA kernel's wrapper takes for a CPU tensor, the port of `_dense_verify`);
it is held against `jax.jit` of JAX's `paged_verify_window(backend="dense")`
on the same seeded numpy inputs, at fp32: outputs within 1e-6 on the live
rows of live slots, pools bit-identical outside the null block 0.

The null block is a race, not a reference: dead rows of every slot and idle
lanes all write block 0, and JAX scatters them with duplicate indices (the
kernel writes them from concurrent CTAs), so block 0 is not compared, and
neither are the outputs of dead rows, which the engine discards.
"""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.paged_verify import (paged_verify_attention,
                                               paged_verify_plain)

L, H, D = 2, 2, 8
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def verify_case(bs, W, seed, dtype=np.float32):
    """Six slots over tables of 6 blocks: an idle lane (position 0, draft
    length 0, null table); a window that starts in the slot's first block
    and crosses into the second (it reads back rows it just wrote in
    both); a draft length of 0 (rows 1.. dead); a window inside one
    block with its last row dead; a window ending at the table's last
    position (its dead rows run past the table); and a window crossing a
    block boundary in a slot that reads another slot's first two blocks
    read-only. Returns the inputs and the live mask `[slots, W]`."""
    rng = np.random.RandomState(seed)
    maxb = 6
    K = W - 1
    last = maxb * bs - 1
    pos = np.array([0, bs - 2, bs + 3, 2 * bs + 1, last - min(2, K),
                    3 * bs + bs - 1], np.int32)
    dlen = np.array([0, K, 0, max(K - 1, 0), min(2, K), K], np.int32)
    tables = np.zeros((6, maxb), np.int32)
    nxt = 1
    for s in range(1, 6):
        nb = (pos[s] + dlen[s]) // bs + 1
        start = 0
        if s == 5:                       # reads slot 4's blocks 0..1
            tables[s, :2] = tables[4, :2]
            start = 2
        tables[s, start:nb] = np.arange(nxt, nxt + nb - start)
        nxt += nb - start
    kpool = rng.randn(L, nxt + 1, bs, H, D).astype(dtype)
    vpool = rng.randn(L, nxt + 1, bs, H, D).astype(dtype)
    q, k, v = (rng.randn(6, W, H, D).astype(dtype) for _ in range(3))
    live = np.arange(W)[None, :] <= dlen[:, None]
    live[0] = False                      # the idle lane's row 0 too
    return (q, k, v, kpool, vpool, tables, pos, dlen), live


def _jax_verify(layer):
    def fn(q, k, v, kp, vp, bt, pos, dlen):
        out, kp, vp = jpa.paged_verify_window(q, k, v, kp, vp, layer, bt,
                                              pos, dlen, backend="dense")
        return out._array, kp._array, vp._array
    return jax.jit(fn)


@pytest.mark.parametrize("bs,W", [(4, 4), (4, 2), (8, 5), (4, 9)])
@pytest.mark.parametrize("layer", [0, 1])
def test_verify_window_matches_jitted_jax(bs, W, layer):
    args, live = verify_case(bs, W, 7 * bs + W)
    q, k, v, kpool, vpool, tables, pos, dlen = args
    jout, jk, jv = _jax_verify(layer)(*args)
    kt, vt = _t(kpool), _t(vpool)
    launches = paged_verify_attention.launches
    plain = paged_verify_attention.plain_calls
    out = tpa.paged_verify_window(_t(q), _t(k), _t(v), kt, vt, layer,
                                  _t(tables), _t(pos), _t(dlen))
    # a CPU tensor takes the plain version, never the kernel
    assert paged_verify_attention.launches == launches
    assert paged_verify_attention.plain_calls == plain + 1
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy()[live], np.asarray(jout)[live],
                               rtol=0, atol=TOL)
    assert np.array_equal(kt.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    assert np.array_equal(vt.numpy()[:, 1:], np.asarray(jv)[:, 1:])


def test_verify_rows_attend_exactly_their_causal_context():
    """Against a dense numpy softmax per live row over the slot's gathered
    keys 0..pos+i, the row's own write included."""
    bs, W = 4, 4
    args, live = verify_case(bs, W, 3)
    q, k, v, kpool, vpool, tables, pos, dlen = args
    kt, vt = _t(kpool), _t(vpool)
    out = paged_verify_plain(_t(q), _t(k), _t(v), kt, vt, 0, _t(tables),
                             _t(pos), _t(dlen)).numpy()
    for s, w in zip(*np.nonzero(live)):
        n = pos[s] + w + 1
        kd, vd = tpa.dense_gather_reference(kt, vt, 0, tables[s], n)
        np.testing.assert_array_equal(kd[n - 1], k[s, w])
        logits = np.einsum("hd,khd->hk", q[s, w], kd) / np.sqrt(D)
        pr = np.exp(logits - logits.max(-1, keepdims=True))
        pr /= pr.sum(-1, keepdims=True)
        np.testing.assert_allclose(out[s, w], np.einsum("hk,khd->hd", pr,
                                                        vd), atol=1e-5)


def test_draft_length_zero_is_the_decode_step():
    """Row 0 of a window with every draft length 0 computes the decode
    step: the same output and the same pools outside the null block."""
    from paddle_tpu_torch.ops.paged_decode import paged_decode_plain

    args, _ = verify_case(4, 3, 5)
    q, k, v, kpool, vpool, tables, pos, _ = args
    dlen = np.zeros_like(pos)
    k1, v1, k2, v2 = (_t(p) for p in (kpool, vpool, kpool, vpool))
    out = paged_verify_plain(_t(q), _t(k), _t(v), k1, v1, 1, _t(tables),
                             _t(pos), _t(dlen))
    ref = paged_decode_plain(_t(q[:, :1]), _t(k[:, :1]), _t(v[:, :1]), k2,
                             v2, 1, _t(tables), _t(pos))
    np.testing.assert_allclose(out[1:, 0].numpy(), ref[1:, 0].numpy(),
                               rtol=0, atol=TOL)
    assert torch.equal(k1[:, 1:], k2[:, 1:])
    assert torch.equal(v1[:, 1:], v2[:, 1:])
