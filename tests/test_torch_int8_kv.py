"""int8 per-block-scaled KV serving of the PyTorch port against the JAX
package.

Ops: the quant-on-write helpers, the int8 decode and verify steps (on CPU
tensors their kernels' wrappers take the plain versions, the attention
halves of `_dense_step_q` and `_dense_verify_q`), the int8 chunked prefill
and the COW copy with scales, each held against `jax.jit` of the JAX op on
the same seeded numpy inputs. Jitted, not eager: under jit XLA turns the
quantizer's `amax / 127.0` into a multiply by the f32 reciprocal of 127,
which the port copies. Codes and scales must be bit-identical outside the
null block 0 and outputs within 1e-6 at f32 on the live rows of live
slots. Block 0 is a race, not a reference: idle lanes, dead window rows
and candidate blocks past a table all route there, as duplicate scatter
indices in JAX and concurrent CTAs on the card.

Engine: the port's engine at `kv_dtype="int8"` (K=0 and K=2) emits the
JAX int8 engine's tokens (`attention_backend="dense"`) exactly, with the
same codes outside block 0 and scales within 1e-6 relative: the model's
matmuls round differently in torch and XLA (the fp pools of the two
engines already differ by ~1e-7), so a block's absmax can differ in its
last bits (a sound run reads 3.6e-7 at most); where the inputs are the
same (the op tests) the scales agree bit for bit. A COW of a shared block carries its scales
(tests/test_engine_quantized.py `_assert_cow_immutable`).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationEngine as JEngine
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch import (GenerationEngine, GPTConfig, GPTForCausalLM,
                              PagedKVCache, load_paddle_tpu_state)
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.paged_decode import paged_decode_attention_int8
from paddle_tpu_torch.ops.paged_verify import paged_verify_attention_int8

L, H, D = 2, 2, 8
TOL = 1e-6
VOCAB = 64
TOKEN_PARITY_MIN = 0.90        # tests/test_engine_quantized.py:41


def _t(a):
    return torch.from_numpy(np.array(a))


def int8_case(bs, W, seed):
    """Six slots, tables of 6 blocks, as the verify test's case (W=1 is a
    decode step): an idle lane, a window in the slot's first block
    crossing into the second, draft length 0, a dead last row, a window
    at the table's end, a slot reading another's first two blocks.
    Pools hold normal rows quantized on per-block grids 0.7 to 1.3 times
    their absmax / 127, so some writes grow their block's grid (and
    requantize its rows) and some do not. Returns the inputs and the live
    mask."""
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
        if s == 5:
            tables[s, :2] = tables[4, :2]
            start = 2
        tables[s, start:nb] = np.arange(nxt, nxt + nb - start)
        nxt += nb - start
    kpool, vpool, scales = quantized_pools(rng, nxt + 1, bs)
    q, k, v = (rng.randn(6, W, H, D).astype(np.float32) for _ in range(3))
    live = np.arange(W)[None, :] <= dlen[:, None]
    live[0] = False
    return (q, k, v, kpool, vpool, scales, tables, pos, dlen), live


def quantized_pools(rng, num_blocks, bs):
    """int8 pools of normal rows on per-block grids 0.7-1.3x absmax/127."""
    x = rng.randn(2, L, num_blocks, bs, H, D).astype(np.float32)
    amax = np.abs(x).max(axis=(3, 4, 5))                  # [2, L, N]
    scales = (amax / 127 * rng.uniform(0.7, 1.3, amax.shape)) \
        .astype(np.float32)
    codes = np.clip(np.round(x / scales[..., None, None, None]), -127, 127)
    return (codes[0].astype(np.int8), codes[1].astype(np.int8),
            np.moveaxis(scales, 0, -1).copy())


def _arrays(out):
    return tuple(getattr(o, "_array", o) for o in out)


def _check_state(kt, vt, st, jk, jv, js):
    """Codes and scales bit-identical outside the null block."""
    assert np.array_equal(kt.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    assert np.array_equal(vt.numpy()[:, 1:], np.asarray(jv)[:, 1:])
    assert np.array_equal(st.numpy()[:, 1:], np.asarray(js)[:, 1:])


def test_scale_grid_multiplies_by_the_f32_reciprocal_like_jitted_jax():
    x = np.abs(np.random.RandomState(0).randn(4096)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: a / 127.0)(x))
    got = (torch.from_numpy(x) * tpa._INV127).numpy()
    assert np.array_equal(got, want)
    # dividing instead lands an ulp off on some of them
    assert not np.array_equal((torch.from_numpy(x) / 127.0).numpy(), want)


@pytest.mark.parametrize("bs,W", [(4, 3), (4, 9), (8, 5)])
def test_window_quant_on_write_matches_jitted_jax(bs, W):
    args, live = int8_case(bs, W, 11 * bs + W)
    q, k, v, kpool, vpool, scales, tables, pos, dlen = args
    jfn = jax.jit(lambda *a: jpa._quant_write_window(*a, 1, None))
    jk, jv, js, jkq, jvq = jfn(kpool, vpool, scales, k, v, tables, pos,
                               dlen)
    kt, vt, st = _t(kpool), _t(vpool), _t(scales)
    kq, vq = tpa._quant_write_window(kt, vt, st, _t(k), _t(v), _t(tables),
                                     _t(pos), _t(dlen), 1)
    _check_state(kt, vt, st, jk, jv, js)
    assert np.array_equal(kq.numpy()[live], np.asarray(jkq)[live])
    assert np.array_equal(vq.numpy()[live], np.asarray(jvq)[live])
    # the case grows some grids and leaves others
    grew = st.numpy()[1, 1:] != scales[1, 1:]
    assert grew.any() and not grew.all()


@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("layer", [0, 1])
def test_int8_decode_step_matches_jitted_jax(bs, layer):
    args, live = int8_case(bs, 1, 5 * bs + layer)
    q, k, v, kpool, vpool, scales, tables, pos, _ = args

    def jfn(q, k, v, kp, vp, sc, bt, pos):
        return _arrays(jpa.paged_attention_step(
            q, k, v, kp, vp, layer, bt, pos, backend="dense", scales=sc))

    jout, jk, jv, js = jax.jit(jfn)(q, k, v, kpool, vpool, scales, tables,
                                    pos)
    kt, vt, st = _t(kpool), _t(vpool), _t(scales)
    launches = paged_decode_attention_int8.launches
    plain = paged_decode_attention_int8.plain_calls
    out = tpa.paged_attention_step(_t(q), _t(k), _t(v), kt, vt, layer,
                                   _t(tables), _t(pos), scales=st)
    assert paged_decode_attention_int8.launches == launches
    assert paged_decode_attention_int8.plain_calls == plain + 1
    np.testing.assert_allclose(out.numpy()[live], np.asarray(jout)[live],
                               rtol=0, atol=TOL)
    _check_state(kt, vt, st, jk, jv, js)


@pytest.mark.parametrize("bs,W", [(4, 4), (4, 9), (8, 3)])
def test_int8_verify_window_matches_jitted_jax(bs, W):
    args, live = int8_case(bs, W, 3 * bs + W)
    q, k, v, kpool, vpool, scales, tables, pos, dlen = args

    def jfn(q, k, v, kp, vp, sc, bt, pos, dlen):
        return _arrays(jpa.paged_verify_window(
            q, k, v, kp, vp, 0, bt, pos, dlen, backend="dense", scales=sc))

    jout, jk, jv, js = jax.jit(jfn)(*args)
    kt, vt, st = _t(kpool), _t(vpool), _t(scales)
    plain = paged_verify_attention_int8.plain_calls
    out = tpa.paged_verify_window(_t(q), _t(k), _t(v), kt, vt, 0,
                                  _t(tables), _t(pos), _t(dlen), scales=st)
    assert paged_verify_attention_int8.plain_calls == plain + 1
    np.testing.assert_allclose(out.numpy()[live], np.asarray(jout)[live],
                               rtol=0, atol=TOL)
    _check_state(kt, vt, st, jk, jv, js)


@pytest.mark.parametrize("start,plen", [(0, 5), (8, 14), (4, 16), (0, 3)])
def test_int8_prefill_chunk_matches_jitted_jax(start, plen):
    """Chunk of 8 over block size 4 with earlier context in the table: the
    chunk may finish a block an earlier chunk started (grow and
    requantize), a candidate block with no valid rows keeps its grid, and
    tail padding past plen writes the null block. Outputs on the real
    positions."""
    rng = np.random.RandomState(start * 31 + plen)
    bs, C = 4, 8
    kpool, vpool, scales = quantized_pools(rng, 12, bs)
    row = np.array([3, 5, 7, 2, 9, 0], np.int32)
    q, k, v = (rng.randn(1, C, H, D).astype(np.float32) for _ in range(3))

    def jfn(q, k, v, kp, vp, sc, row, s0, n):
        return _arrays(jpa.paged_prefill_chunk(q, k, v, kp, vp, 1, row, s0,
                                               n, scales=sc))

    jo, jk, jv, js = jax.jit(jfn)(q, k, v, kpool, vpool, scales, row,
                                  np.int32(start), np.int32(plen))
    kt, vt, st = _t(kpool), _t(vpool), _t(scales)
    out = tpa.paged_prefill_chunk(_t(q), _t(k), _t(v), kt, vt, 1, _t(row),
                                  start, plen, scales=st)
    real = min(C, plen - start)
    np.testing.assert_allclose(out.numpy()[0, :real],
                               np.asarray(jo)[0, :real], rtol=0, atol=TOL)
    _check_state(kt, vt, st, jk, jv, js)


def test_copy_pool_block_carries_the_scales_like_jax():
    args, _ = int8_case(4, 1, 2)
    kpool, vpool, scales = args[3:6]
    jk, jv, js = jpa.copy_pool_block(kpool, vpool, 2, 5, scales)
    kt, vt, st = _t(kpool), _t(vpool), _t(scales)
    tpa.copy_pool_block(kt, vt, 2, 5, st)
    assert np.array_equal(kt.numpy(), np.asarray(jk))
    assert np.array_equal(vt.numpy(), np.asarray(jv))
    assert np.array_equal(st.numpy(), np.asarray(js))


def test_int8_cache_layout_reset_and_bytes():
    c = PagedKVCache(2, 8, 4, 2, 8, dtype=torch.bfloat16, device="cpu",
                     kv_dtype="int8")
    assert c.kpool.dtype == torch.int8 and c.pool_spec()[1] == torch.int8
    assert c.scale_spec() == ((2, 8, 2), torch.float32)
    assert bool((c.scales == np.float32(tpa.KV_QUANT_EPS)).all())
    fp = PagedKVCache(2, 8, 4, 2, 8, dtype=torch.bfloat16, device="cpu")
    assert fp.scales is None and fp.scale_spec() is None
    assert c.pool_nbytes() == fp.pool_nbytes() // 2 + 2 * 8 * 2 * 4
    got = c.allocate(2)
    c.scales[:, got] = 0.5                  # a tenant's grid
    c.free(got)
    again = c.allocate(2)                   # the LIFO hands them back
    assert sorted(again) == sorted(got)
    assert bool((c.scales[:, again] == np.float32(1e-8)).all())
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedKVCache(2, 8, 4, 2, 8, device="cpu", kv_dtype="fp8")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    kw = dict(vocab=VOCAB, hidden=32, layers=2, heads=4, seq=64)
    jm = JGPT(JConfig.tiny(**kw))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig.tiny(**kw), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v._array)
                               for k, v in jm.state_dict().items()})
    return jm, tm.eval()


def _mixed_trace(rng, n=4):
    """tests/test_engine_quantized.py's mixed trace: mixed lengths, a hot
    shared prefix and a block-aligned full-prefix hit (block size 4)."""
    reqs = [(rng.randint(0, VOCAB, rng.randint(2, 13)).astype(np.int32),
             int(rng.randint(2, 7))) for _ in range(n)]
    shared = rng.randint(0, VOCAB, 8).astype(np.int32)
    reqs += [(np.concatenate([shared, rng.randint(0, VOCAB, 3)])
              .astype(np.int32), 4),
             (shared.copy(), 4)]
    return reqs


def _serve(eng, reqs):
    """Half the trace, three steps, the rest mid-run; then the last
    (block-aligned) prompt once more: a full-prefix hit whose first write
    takes a copy-on-write."""
    ids = [eng.add_request(p, n) for p, n in reqs[:len(reqs) // 2]]
    for _ in range(3):
        eng.step()
    ids += [eng.add_request(p, n) for p, n in reqs[len(reqs) // 2:]]
    out = eng.run()
    again = eng.add_request(*reqs[-1])
    out.update(eng.run())
    return [list(out[i]) for i in ids + [again]]


@pytest.mark.parametrize("K", [0, 2])
def test_int8_engine_token_identical_to_jax_int8_engine(models, K):
    jm, tm = models
    kw = dict(num_slots=3, block_size=4, num_blocks=48, prefill_chunk=8,
              kv_dtype="int8", spec_decode_k=K)
    reqs = _mixed_trace(np.random.RandomState(7)) \
        + _mixed_trace(np.random.RandomState(8), n=2)
    jeng = JEngine(jm, attention_backend="dense", **kw)
    teng = GenerationEngine(tm, device="cpu", **kw)
    want = _serve(jeng, reqs)
    got = _serve(teng, reqs)
    assert got == want
    assert teng.prefix_hit_tokens == jeng.prefix_hit_tokens > 0
    assert teng.cow_copies >= 1
    if K:
        assert (teng.spec_accepted_tokens, teng.spec_rejected_tokens) == (
            jeng._m_spec_ok.value, jeng._m_spec_rej.value)
    # same block ids: the same codes, and the same grids up to the
    # matmuls' rounding, outside the null block
    for t, j in ((teng.cache.kpool, jeng.cache.kpool),
                 (teng.cache.vpool, jeng.cache.vpool)):
        assert np.array_equal(t.numpy()[:, 1:], np.asarray(j)[:, 1:])
    np.testing.assert_allclose(teng.cache.scales.numpy()[:, 1:],
                               np.asarray(jeng.cache.scales)[:, 1:],
                               rtol=1e-6, atol=0)
    assert teng.cache.leak_check() == []
    # within the int8 budget of the fp engine's tokens
    fp = _serve(GenerationEngine(tm, device="cpu", **dict(kw, kv_dtype=None)),
                reqs)
    same = sum(a == b for g, f in zip(got, fp) for a, b in zip(g, f))
    assert same / sum(len(f) for f in fp) >= TOKEN_PARITY_MIN


def test_int8_cow_keeps_shared_blocks_and_scales(models):
    """A borrower decoding off shared quantized prefix blocks never changes
    the cached codes or their scales: the COW copy carries the grid."""
    _, tm = models
    rng = np.random.RandomState(3)
    shared = rng.randint(0, VOCAB, 8).astype(np.int32)   # 2 blocks
    eng = GenerationEngine(tm, num_slots=2, block_size=4, num_blocks=32,
                           prefill_chunk=8, kv_dtype="int8", device="cpu")
    rid = eng.add_request(shared, 3)
    first = eng.run()[rid]
    cached = sorted(eng.cache._hash_of)
    assert len(cached) >= 2
    snap = [t[:, cached].clone() for t in (eng.cache.kpool, eng.cache.vpool,
                                           eng.cache.scales)]
    rid2 = eng.add_request(shared.copy(), 3)
    second = eng.run()[rid2]
    assert eng.prefix_hit_tokens >= len(shared) and eng.cow_copies >= 1
    assert first == second
    for before, now in zip(snap, (eng.cache.kpool, eng.cache.vpool,
                                  eng.cache.scales)):
        assert torch.equal(now[:, cached], before)


def test_deploy_switches_build_the_engine_jax_builds(models, monkeypatch):
    """ROADMAP Queue C 14: `PADDLE_SPEC_DECODE_K` and `PADDLE_SERVE_KV_DTYPE`
    win over the constructor's arguments in both packages: under K=2 and
    int8 an engine asked for K=0 and fp pools verifies two drafts over int8
    pools of JAX's bytes, and serves the JAX engine's tokens; an explicit
    argument of the other value loses too, and an empty value is unset."""
    for var in ("PADDLE_SPEC_DECODE_K", "PADDLE_SERVE_KV_DTYPE",
                "PADDLE_SERVE_MP", "PADDLE_SERVE_WEIGHT_DTYPE",
                "PADDLE_SERVE_SAMPLING", "PADDLE_SERVE_TRACING",
                "PADDLE_SERVE_ASYNC", "PADDLE_PAGED_ATTENTION_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PADDLE_SPEC_DECODE_K", "2")
    monkeypatch.setenv("PADDLE_SERVE_KV_DTYPE", "int8")
    jm, tm = models
    kw = dict(num_slots=3, block_size=4, num_blocks=48, prefill_chunk=8)
    jeng = JEngine(jm, attention_backend="dense", **kw)
    teng = GenerationEngine(tm, device="cpu", **kw)
    assert teng.spec_decode_k == jeng.spec_decode_k == 2
    assert teng.kv_dtype == jeng.kv_dtype == "int8"
    assert teng.cache.kpool.dtype == torch.int8
    assert np.asarray(jeng.cache.kpool).dtype == np.int8
    assert teng.cache.pool_nbytes() == jeng.cache.pool_nbytes()
    reqs = _mixed_trace(np.random.RandomState(7))
    assert _serve(teng, reqs) == _serve(jeng, reqs)
    assert teng.spec_accepted_tokens + teng.spec_rejected_tokens > 0
    monkeypatch.setenv("PADDLE_SPEC_DECODE_K", "0")
    both = [E(m, spec_decode_k=3, kv_dtype=None, **dict(kw, **extra))
            for E, m, extra in ((JEngine, jm, {"attention_backend": "dense"}),
                                (GenerationEngine, tm, {"device": "cpu"}))]
    assert [(e.spec_decode_k, e.kv_dtype) for e in both] == [(0, "int8")] * 2
    monkeypatch.setenv("PADDLE_SPEC_DECODE_K", "")
    monkeypatch.setenv("PADDLE_SERVE_KV_DTYPE", "")
    eng = GenerationEngine(tm, device="cpu", spec_decode_k=3, **kw)
    assert (eng.spec_decode_k, eng.kv_dtype, eng.cache.scales) == (3, None,
                                                                   None)
