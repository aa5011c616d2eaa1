"""The PyTorch port's serving engine against the JAX engine.

Both engines get the same weights (the JAX model's `state_dict()` through
the weight bridge), the same configuration and the same request trace; the
JAX engine runs its dense attention backend with chunked prefill. Greedy
tokens must be identical, block allocation included (so the two pools can
be compared slot by slot), and the port's `drain()` leak check must pass.
Traces: mid-run arrivals (tests/test_inference_engine.py), EOS with pool
pressure (ibid.), and shared prefixes with a full-prefix hit that takes a
copy-on-write (tests/test_engine_prefix_cache.py).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationEngine as JEngine
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.ops.paged_attention import \
    dense_gather_reference as j_gather
from paddle_tpu_torch import (GenerationEngine, GPTConfig, GPTForCausalLM,
                              load_paddle_tpu_state)
from paddle_tpu_torch.ops.paged_attention import dense_gather_reference
from paddle_tpu_torch.ops.paged_decode import paged_decode_attention

VOCAB = 61


def _models(vocab=VOCAB):
    paddle.seed(0)
    kw = dict(vocab=vocab, hidden=32, layers=2, heads=2, seq=64)
    jm = JGPT(JConfig.tiny(**kw))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig.tiny(**kw), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v._array)
                               for k, v in jm.state_dict().items()})
    return jm, tm.eval()


@pytest.fixture(scope="module")
def models():
    return _models()


def _engines(models, **kw):
    jm, tm = models
    return (JEngine(jm, attention_backend="dense", **kw),
            GenerationEngine(tm, device="cpu", **kw))


def _drive(eng, first, later, steps, finish):
    ids = [eng.add_request(p, n, **e) for p, n, e in first]
    for _ in range(steps):
        eng.step()
    ids += [eng.add_request(p, n, **e) for p, n, e in later]
    out = finish(eng)
    return [list(out[i]) for i in ids]


def _both(models, first, later, steps=3, **kw):
    jeng, teng = _engines(models, **kw)
    want = _drive(jeng, first, later, steps, lambda e: e.run())
    got = _drive(teng, first, later, steps, lambda e: e.drain())
    return jeng, teng, want, got


def _reqs(rng, n, lo, hi, new_lo, new_hi):
    return [(rng.randint(0, VOCAB, rng.randint(lo, hi)).astype(np.int32),
             int(rng.randint(new_lo, new_hi)), {}) for _ in range(n)]


def test_midrun_arrivals_token_identical_to_jax(models):
    rng = np.random.RandomState(0)
    reqs = _reqs(rng, 8, 1, 8, 3, 10)
    jeng, teng, want, got = _both(models, reqs[:4], reqs[4:], num_slots=3,
                                  block_size=4, num_blocks=40)
    assert got == want
    assert teng.tokens_generated == sum(n for _, n, _ in reqs)
    assert teng.decode_steps > 0 and teng.num_active == 0


def test_eos_and_pool_pressure_token_identical_to_jax(models):
    """8 usable blocks of 4 tokens against 3 lanes that want up to 17:
    lanes stall and retry; one request stops early on EOS."""
    jm, tm = models
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, VOCAB, 5).astype(np.int32)
    plain = tm.generate(torch.from_numpy(prompt)[None], max_length=17,
                        use_cache=True)[0].numpy()
    eos = int(plain[len(prompt) + 2])            # the 3rd generated token
    reqs = _reqs(rng, 4, 2, 7, 4, 9) + [(prompt, 12,
                                         {"eos_token_id": eos})]
    jeng, teng, want, got = _both(models, reqs, [], steps=0, num_slots=3,
                                  block_size=4, num_blocks=9)
    assert got == want
    assert got[-1][-1] == eos and len(got[-1]) < len(prompt) + 12
    assert sum(teng.stalls.values()) > 0
    assert teng.cache.num_free == teng.cache.num_blocks - 1


def test_shared_prefix_and_cow_trace_token_identical_to_jax(models):
    """Shared 8-token prefixes and a block-aligned prompt served twice:
    the repeat seats all its blocks from the cache, its first decode write
    lands in a cached block and copies it first; the cached bytes stay
    unchanged and both engines' pools agree slot by slot."""
    rng = np.random.RandomState(11)
    shared = rng.randint(0, VOCAB, 8).astype(np.int32)
    base = _reqs(rng, 4, 1, 14, 2, 9)
    first = base + [
        (np.concatenate([shared, rng.randint(0, VOCAB, 3)])
         .astype(np.int32), 4, {}),
        (shared.copy(), 4, {})]
    later = [(np.concatenate([shared, rng.randint(0, VOCAB, 5)])
              .astype(np.int32), 3, {}),
             (shared.copy(), 5, {})]              # full-prefix hit: COW
    kw = dict(num_slots=3, block_size=4, num_blocks=64, prefill_chunk=8)
    jeng, teng, want, got = _both(models, first, later, steps=12, **kw)
    assert got == want
    assert teng.prefix_hit_tokens == jeng.prefix_hit_tokens > 0
    assert teng.cow_copies >= 1
    # the shared prompt's cached blocks: same ids, same bytes in both
    blocks, hit = teng.cache.match_prefix(shared)
    jblocks, jhit = jeng.cache.match_prefix(shared)
    assert (blocks, hit) == (jblocks, jhit) and hit == 8
    row = np.zeros(teng.max_blocks, np.int32)
    row[:len(blocks)] = blocks
    for layer in range(2):
        tk, tv = dense_gather_reference(teng.cache.kpool, teng.cache.vpool,
                                        layer, row, hit)
        jk, jv = j_gather(jeng.cache.kpool, jeng.cache.vpool, layer, row,
                          hit)
        np.testing.assert_allclose(tk, np.asarray(jk), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5, rtol=0)
    teng.cache.free(blocks)
    assert teng.cache.leak_check() == []


def test_engine_on_cpu_takes_the_plain_decode(models):
    _, tm = models
    eng = GenerationEngine(tm, num_slots=2, block_size=4, device="cpu")
    launches = paged_decode_attention.launches
    plain = paged_decode_attention.plain_calls
    eng.add_request([1, 2, 3], 4)
    eng.drain()
    assert paged_decode_attention.launches == launches
    # 3 decode steps x 2 layers
    assert paged_decode_attention.plain_calls == plain + 3 * 2


def test_priority_admission_and_shedding(models):
    _, tm = models
    eng = GenerationEngine(tm, num_slots=1, block_size=4, num_blocks=32,
                           prefill_chunk=8, max_queue=2, device="cpu")
    p = np.arange(12) % VOCAB
    keep = [eng.add_request(p, 2, priority="standard"),
            eng.add_request(p, 2, priority="batch")]
    vip = eng.add_request(p, 2, priority="interactive")   # sheds batch
    loser = eng.add_request(p, 2, priority="batch")        # sheds itself
    eng.step()
    seated = [s for s in eng._slots if s is not None]
    assert seated[0].req.req_id == vip                     # jumped ahead
    out = eng.drain()
    assert out[keep[1]] is None and out[loser] is None and eng.shed == 2
    assert out[keep[0]] == out[vip] and len(out[vip]) == 14
    with pytest.raises(ValueError, match="priority"):
        GenerationEngine(tm, device="cpu").add_request(p, 2,
                                                       priority="vip")
    with pytest.raises(RuntimeError, match="draining"):
        eng.add_request(p, 2)


def test_request_validation_and_loud_deadlock(models):
    _, tm = models
    eng = GenerationEngine(tm, num_slots=2, device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.add_request([], 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.add_request([1, 2], 0)
    with pytest.raises(ValueError, match="exceeds max_model_len"):
        eng.add_request(np.zeros(60, np.int32), 10)
    small = GenerationEngine(tm, num_slots=2, block_size=4, num_blocks=3,
                             device="cpu")
    small.add_request(np.arange(12) % VOCAB, 4)   # needs 3 blocks, has 2
    with pytest.raises(RuntimeError, match="grow num_blocks"):
        small.run()


def test_allocator_refcounts_prefix_lru_and_leak_check():
    """The port's PagedKVCache bookkeeping: double free and the null block
    raise, share/free keep refcounts exact, cached blocks park evictable
    at refcount 0 and are reclaimed oldest first, deepest link first."""
    from paddle_tpu_torch import PagedKVCache

    c = PagedKVCache(1, 8, 4, 2, 8, device="cpu")    # 7 usable blocks
    toks = np.arange(12, dtype=np.int32)             # 3 full blocks
    blocks = c.allocate(3)
    c.share(blocks[:1])
    assert [c.refcount(b) for b in blocks] == [2, 1, 1]
    c.free(blocks[:1])
    with pytest.raises(ValueError, match="null block"):
        c.free([0])
    assert c.register_prefix(toks, blocks) == 3
    assert c.register_prefix(toks, blocks) == 0      # first writer wins
    assert c.needs_cow(blocks[0]) and c.leak_check() == sorted(blocks)
    c.free(blocks)
    with pytest.raises(RuntimeError, match="double free"):
        c.free(blocks[:1])
    with pytest.raises(RuntimeError, match="dead block"):
        c.share(blocks[:1])
    assert c.num_free == 7 and c.leak_check() == []
    assert c.warm_prefix_tokens(toks[:9]) == 8
    again, hit = c.match_prefix(toks)                # revived
    assert (again, hit) == (blocks, 12)
    c.free(again)
    got = c.allocate(6)                              # 4 free + 2 evicted
    assert got is not None and c.warm_prefix_tokens(toks) == 4
    assert c.allocate(2) is None                     # the stall path


@pytest.mark.parametrize("backend", ["dense", "pallas", "auto"])
def test_attention_backend_seam_token_identical_to_jax(models, backend,
                                                       monkeypatch):
    """`attention_backend` (ROADMAP Queue C 9): each port backend serves
    JAX's dense engine's tokens. `dense` runs the plain dense paged path,
    counted in `paged_attention_step.dense_calls`; `pallas` goes through
    the kernel's wrapper (its plain version on the CPU); `auto` resolves
    dense here, as JAX's rule does at head dim 16. The environment's
    PADDLE_PAGED_ATTENTION_BACKEND wins over the argument, and
    `resolve_backend` takes JAX's names and rule."""
    from paddle_tpu.ops.paged_attention import resolve_backend as j_resolve
    from paddle_tpu_torch.ops import paged_attention as tpa

    monkeypatch.delenv("PADDLE_PAGED_ATTENTION_BACKEND", raising=False)
    rng = np.random.RandomState(5)
    reqs = _reqs(rng, 5, 2, 9, 3, 8)
    kw = dict(num_slots=3, block_size=4, num_blocks=40)
    jeng = JEngine(models[0], attention_backend="dense", **kw)
    want = _drive(jeng, reqs[:3], reqs[3:], 2, lambda e: e.run())
    teng = GenerationEngine(models[1], device="cpu",
                            attention_backend=backend, **kw)
    assert teng.attention_backend_requested == backend
    assert teng.attention_backend == ("pallas" if backend == "pallas"
                                      else "dense")
    dense = tpa.paged_attention_step.dense_calls
    plain = paged_decode_attention.plain_calls
    got = _drive(teng, reqs[:3], reqs[3:], 2, lambda e: e.drain())
    assert got == want
    steps = teng.decode_steps * 2                        # two layers
    assert tpa.paged_attention_step.dense_calls - dense == \
        (0 if backend == "pallas" else steps)
    assert paged_decode_attention.plain_calls - plain == steps
    monkeypatch.setenv("PADDLE_PAGED_ATTENTION_BACKEND", "pallas")
    assert GenerationEngine(models[1], device="cpu", attention_backend=backend,
                            **kw).attention_backend == "pallas"
    # JAX's `auto` takes the kernel only on a TPU, at head_dim >= 64 and
    # block_size >= 8; the port's on every device, where the CUDA kernel
    # also takes the shape (head dims 64 and 128, blocks of 8 to 64)
    for hd, bs, auto in ((16, 16, "dense"), (64, 4, "dense"),
                         (64, 16, "pallas"), (128, 8, "pallas"),
                         (96, 16, "dense"), (64, 128, "dense")):
        for name in ("dense", "pallas"):
            assert tpa.resolve_backend(name, hd, bs) == \
                j_resolve(name, hd, bs) == name
        assert tpa.resolve_backend("auto", hd, bs) == auto, (hd, bs)
    with pytest.raises(ValueError, match="backend"):
        tpa.resolve_backend("cuda", 64, 16)


# ROADMAP Queue C 14: the deploy switches and `prefill_chunk`, as JAX
# resolves them
SWITCHES = ("PADDLE_SPEC_DECODE_K", "PADDLE_SERVE_KV_DTYPE", "PADDLE_SERVE_MP",
            "PADDLE_SERVE_WEIGHT_DTYPE", "PADDLE_SERVE_SAMPLING",
            "PADDLE_SERVE_TRACING", "PADDLE_SERVE_ASYNC",
            "PADDLE_PAGED_ATTENTION_BACKEND")


@pytest.fixture
def no_switches(monkeypatch):
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _raised(fn):
    """(exception type, message) of what `fn()` raised, or None."""
    try:
        fn()
    except Exception as e:                      # noqa: BLE001
        return type(e), str(e)
    return None


@pytest.mark.parametrize("max_model_len", [None, 40, 7])
def test_prefill_chunk_auto_is_jax_chunk(models, no_switches, max_model_len):
    """`prefill_chunk="auto"`, the default in both packages, resolves to
    JAX's `min(128, max_model_len)`, and the engines serve the same
    tokens from it; an int is clamped as in JAX."""
    jm, tm = models
    kw = dict(num_slots=2, block_size=4, num_blocks=40,
              max_model_len=max_model_len)
    jeng = JEngine(jm, attention_backend="dense", **kw)
    teng = GenerationEngine(tm, device="cpu", **kw)
    assert teng.prefill_chunk == jeng.prefill_chunk == \
        min(128, max_model_len or 64)
    assert GenerationEngine(tm, device="cpu", prefill_chunk="auto",
                            **kw).prefill_chunk == teng.prefill_chunk
    for chunk in (0, 5, 500):
        assert GenerationEngine(tm, device="cpu", prefill_chunk=chunk,
                                **kw).prefill_chunk == \
            JEngine(jm, attention_backend="dense", prefill_chunk=chunk,
                    **kw).prefill_chunk
    rng = np.random.RandomState(2)
    hi = min(6, (max_model_len or 64) - 1)
    reqs = [(rng.randint(0, VOCAB, rng.randint(1, hi)).astype(np.int32),
             int((max_model_len or 64) - hi), {}) for _ in range(3)]
    want = _drive(jeng, reqs[:2], reqs[2:], 1, lambda e: e.run())
    got = _drive(teng, reqs[:2], reqs[2:], 1, lambda e: e.drain())
    assert got == want


@pytest.mark.parametrize("kw,raises", [
    (dict(prefill_chunk=None), None),
    (dict(prefill_buckets=(16, 64)), None),
    (dict(prefill_chunk="auto", prefill_buckets=(16, 64)), None),
    (dict(prefill_chunk=8, prefill_buckets=(16, 64)), ValueError),
    (dict(prefill_chunk="eight"), ValueError)])
def test_bucketed_prefill_raises_instead_of_chunking(models, no_switches, kw,
                                                     raises):
    """The prefill strategy resolves as JAX resolves it: a None chunk, or
    buckets with the chunk left at "auto", select bucketed prefill (the
    same buckets, no chunk, no prefix cache) and never chunked prefill in
    its place; a chunk beside buckets, or a chunk that is not an int,
    raises JAX's ValueError."""
    jm, tm = models
    got = _raised(lambda: GenerationEngine(tm, device="cpu", num_slots=2,
                                           block_size=4, **kw))
    want = _raised(lambda: JEngine(jm, attention_backend="dense",
                                   num_slots=2, block_size=4, **kw))
    assert got == want
    if raises is None:
        teng = GenerationEngine(tm, device="cpu", num_slots=2, block_size=4,
                                **kw)
        jeng = JEngine(jm, attention_backend="dense", num_slots=2,
                       block_size=4, **kw)
        assert teng.prefill_chunk is None and not teng.chunked_prefill
        assert teng.prefill_buckets == jeng.prefill_buckets
        assert teng.enable_prefix_cache is jeng.enable_prefix_cache is False
    else:
        assert got is not None and got[0] is raises


@pytest.mark.parametrize("var,value,item", [
    ("PADDLE_SERVE_MP", "2", "Queue A 10"),
    ("PADDLE_SERVE_WEIGHT_DTYPE", "int8", "Queue A 7"),
    ("PADDLE_SERVE_SAMPLING", "1", "Queue A 6"),
    ("PADDLE_SERVE_TRACING", "on", "Queue A 11"),
    ("PADDLE_SERVE_ASYNC", "true", "Queue A 11")])
def test_unported_switch_raises_rather_than_serving_without_it(
        models, no_switches, var, value, item):
    """Every deploy switch of the JAX engine turns its feature on in the
    port as in JAX, now that the ROADMAP items that port them are done (6,
    sampling; 7, int8 weights; 10, tensor parallel, on a model whose
    vocab 2 divides; 11, tracing and the async core); none serves without
    its feature. The engine built under the switch serves JAX's tokens."""
    no_switches.setenv(var, value)
    ported = {"PADDLE_SERVE_SAMPLING": ("sampling", True),
              "PADDLE_SERVE_WEIGHT_DTYPE": ("weight_dtype", "int8"),
              "PADDLE_SERVE_MP": ("mp_degree", 2),
              "PADDLE_SERVE_TRACING": ("tracing", True),
              "PADDLE_SERVE_ASYNC": ("async_core", True)}
    attr, on = ported[var]
    jm, tm = models
    if var == "PADDLE_SERVE_MP":
        # vocab 61 cannot be sharded: both packages refuse it alike
        assert _raised(lambda: GenerationEngine(
            tm, device="cpu", num_slots=2, block_size=4)) == _raised(
            lambda: JEngine(jm, num_slots=2, block_size=4))
        jm, tm = _models(vocab=64)
    teng = GenerationEngine(tm, device="cpu", num_slots=2, block_size=4)
    jeng = JEngine(jm, attention_backend="dense", num_slots=2,
                   block_size=4)
    assert getattr(teng, attr) == getattr(jeng, attr) == on, item
    if var == "PADDLE_SERVE_MP":
        assert len(teng.cache.kpools) == 2
    if var in ("PADDLE_SERVE_MP", "PADDLE_SERVE_TRACING",
               "PADDLE_SERVE_ASYNC"):
        V = tm.config.vocab_size
        rng = np.random.RandomState(3)
        reqs = [(rng.randint(0, V, n).astype(np.int32), 4)
                for n in (3, 9)]
        assert _drive(teng, [r + ({},) for r in reqs], [], 0,
                      lambda e: e.drain()) == _drive(
            jeng, [r + ({},) for r in reqs], [], 0, lambda e: e.run())


@pytest.mark.parametrize("var,value", [
    ("PADDLE_SERVE_MP", "1"), ("PADDLE_SERVE_MP", ""),
    ("PADDLE_SERVE_WEIGHT_DTYPE", ""), ("PADDLE_SERVE_SAMPLING", "0"),
    ("PADDLE_SERVE_TRACING", "off"), ("PADDLE_SERVE_ASYNC", "no"),
    ("PADDLE_SPEC_DECODE_K", ""), ("PADDLE_SERVE_KV_DTYPE", "")])
def test_switch_off_or_unset_serves_as_before(models, no_switches, var,
                                              value):
    """Off, one degree and the empty string (unset) build the engine the
    arguments ask for, in both packages."""
    no_switches.setenv(var, value)
    jm, tm = models
    kw = dict(num_slots=2, block_size=4, num_blocks=40, spec_decode_k=1)
    teng = GenerationEngine(tm, device="cpu", **kw)
    jeng = JEngine(jm, attention_backend="dense", **kw)
    assert teng.spec_decode_k == jeng.spec_decode_k == 1
    assert teng.kv_dtype is None and jeng.kv_dtype is None
    rng = np.random.RandomState(4)
    reqs = _reqs(rng, 3, 2, 9, 3, 8)
    assert _drive(teng, reqs, [], 0, lambda e: e.drain()) == \
        _drive(jeng, reqs, [], 0, lambda e: e.run())


@pytest.mark.parametrize("var,value", [
    ("PADDLE_SPEC_DECODE_K", "two"), ("PADDLE_SPEC_DECODE_K", "-1"),
    ("PADDLE_SERVE_KV_DTYPE", "fp8"), ("PADDLE_SERVE_MP", "x"),
    ("PADDLE_SERVE_MP", "0"), ("PADDLE_SERVE_WEIGHT_DTYPE", "int4"),
    ("PADDLE_SERVE_SAMPLING", "maybe"), ("PADDLE_SERVE_TRACING", "2"),
    ("PADDLE_SERVE_ASYNC", "later")])
def test_bad_switch_value_raises_as_jax(models, no_switches, var, value):
    """A switch's bad value raises the JAX engine's ValueError, message
    and all."""
    no_switches.setenv(var, value)
    jm, tm = models
    got = _raised(lambda: GenerationEngine(tm, device="cpu", num_slots=2,
                                           block_size=4))
    want = _raised(lambda: JEngine(jm, attention_backend="dense",
                                   num_slots=2, block_size=4))
    assert got is not None and got[0] is ValueError
    assert got == want
