"""Bucketed prefill of the PyTorch port against the JAX package, on the CPU.

- `paged_prefill_write`: fp pools (f32 and bf16) bitwise equal to JAX's
  whole, the null block included, for prompt lengths at, below and above
  bucket and block edges; int8 codes and scales bitwise equal to jitted
  JAX's outside the null block 0 (jitted: XLA multiplies by the f32
  reciprocal of 127, as the port does), from scale rows at the floor (the
  allocator's reset) and a null block whose grid an idle lane grew.
- The bucket ladder (`_default_buckets`, `_bucket_for`) and the strategy's
  resolution and errors equal JAX's.
- The bucketed engine (`prefill_chunk=None` or `prefill_buckets=`) emits
  the JAX bucketed engine's tokens at f32: greedy at K=0 and K=4, int8 KV,
  int8 weights, and sampled lanes (JAX's draws, token for token), block
  stalls at admission included; at fp pools it also emits the port's
  chunked engine's tokens. `forward_prefill` under the int8 weight
  snapshot reads it through `int8_linear`.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationEngine as JEngine
from paddle_tpu.inference import SamplingParams as JParams
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch import (GenerationEngine, GPTConfig, GPTForCausalLM,
                              load_paddle_tpu_state)
from paddle_tpu_torch.inference import SamplingParams
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.int8_linear import int8_linear

VOCAB = 64
L, HEADS, D, BS, MAXB = 2, 2, 8, 4, 10


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


@pytest.fixture
def no_switches(monkeypatch):
    for var in ("PADDLE_SPEC_DECODE_K", "PADDLE_SERVE_KV_DTYPE",
                "PADDLE_SERVE_WEIGHT_DTYPE", "PADDLE_SERVE_SAMPLING",
                "PADDLE_PAGED_ATTENTION_BACKEND", "PADDLE_SERVE_MP"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _raised(fn):
    """(exception type, message) of what `fn()` raised, or None."""
    try:
        fn()
    except Exception as e:                      # noqa: BLE001
        return type(e), str(e)
    return None


def _prefill_case(S, plen, seed, int8=False):
    """Pools of 12 blocks, a table of fresh blocks 3, 7, 1, ... for the
    prompt, k/v stacks `[L, 1, S, heads, D]` of a bucket-padded prompt."""
    rng = np.random.RandomState(seed)
    nblk = 12
    if int8:
        kpool = rng.randint(-127, 128, (L, nblk, BS, HEADS, D)).astype(np.int8)
        vpool = rng.randint(-127, 128, (L, nblk, BS, HEADS, D)).astype(np.int8)
        scales = np.full((L, nblk, 2), tpa.KV_QUANT_EPS, np.float32)
        scales[:, 0] = 0.02                    # an idle lane grew block 0
        scales[:, 5] = 0.03                    # a live block elsewhere
    else:
        kpool = rng.randn(L, nblk, BS, HEADS, D).astype(np.float32)
        vpool = rng.randn(L, nblk, BS, HEADS, D).astype(np.float32)
        scales = None
    ks = (rng.randn(L, 1, S, HEADS, D) * 2).astype(np.float32)
    vs = (rng.randn(L, 1, S, HEADS, D) * 2).astype(np.float32)
    row = np.zeros(MAXB, np.int32)
    need = -(-plen // BS)
    row[:need] = [3, 7, 1, 9, 2, 11, 4, 8, 6, 10][:need]
    return kpool, vpool, scales, ks, vs, row


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# (bucket S, plen): at a bucket edge, below it, above a block edge, one row
# past the smaller bucket, a single token
PREFILL_CASES = [(16, 16), (16, 15), (16, 13), (32, 17), (16, 1), (32, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,plen", PREFILL_CASES)
def test_paged_prefill_write_fp_bitwise_jax(dtype, S, plen):
    kpool, vpool, _, ks, vs, row = _prefill_case(S, plen, S + plen)
    jdt = {torch.float32: np.float32, torch.bfloat16: jax.numpy.bfloat16}
    jk, jv = (t._array for t in jpa.paged_prefill_write(
        jax.numpy.asarray(kpool, jdt[dtype]),
        jax.numpy.asarray(vpool, jdt[dtype]),
        jax.numpy.asarray(ks, jdt[dtype]), jax.numpy.asarray(vs, jdt[dtype]),
        row, np.int32(plen)))
    tk, tv = _t(kpool, dtype), _t(vpool, dtype)
    assert tpa.paged_prefill_write(tk, tv, _t(ks, dtype), _t(vs, dtype),
                                   _t(row), plen) is None       # in place
    for got, want in ((tk, jk), (tv, jv)):
        want = torch.from_numpy(np.array(want.astype(np.float32)))
        assert torch.equal(got.float(), want)


@pytest.mark.parametrize("S,plen", PREFILL_CASES)
def test_paged_prefill_write_int8_matches_jitted_jax(S, plen):
    kpool, vpool, scales, ks, vs, row = _prefill_case(S, plen, 7 * S + plen,
                                                      int8=True)
    jfn = jax.jit(lambda *a: tuple(t._array for t in
                                   jpa.paged_prefill_write(*a[:4], a[5], a[6],
                                                           scales=a[4])))
    jk, jv, js = jfn(kpool, vpool, ks, vs, scales, row, np.int32(plen))
    tk, tv, ts = _t(kpool), _t(vpool), _t(scales)
    tpa.paged_prefill_write(tk, tv, _t(ks), _t(vs), _t(row), plen, scales=ts)
    assert np.array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    assert np.array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])
    assert np.array_equal(ts.numpy(), np.asarray(js))
    # the prompt's blocks grew from the floor; the others kept their grids
    written = row[:-(-plen // BS)]
    assert (ts[:, written] > tpa.KV_QUANT_EPS).all()
    assert (ts[:, 5] == 0.03).all()


@pytest.mark.parametrize("max_model_len", [64, 40, 16, 7])
def test_bucket_ladder_equals_jax(models, no_switches, max_model_len):
    jm, tm = models
    kw = dict(num_slots=2, block_size=4, prefill_chunk=None,
              max_model_len=max_model_len)
    teng = GenerationEngine(tm, device="cpu", **kw)
    jeng = JEngine(jm, attention_backend="dense", **kw)
    assert teng.prefill_buckets == jeng.prefill_buckets
    assert teng._default_buckets() == jeng._default_buckets()
    for plen in range(1, max_model_len + 1):
        assert teng._bucket_for(plen) == jeng._bucket_for(plen)


STRATEGY_CASES = [
    dict(prefill_chunk=None, enable_prefix_cache=True),
    dict(prefill_buckets=(16, 64), enable_prefix_cache=True),
    dict(prefill_buckets=(8, 16)),
    dict(prefill_chunk=None, prefill_buckets=(64, 8, 32)),
    dict(prefill_chunk=None, enable_prefix_cache=False),
    dict(prefill_chunk=4, enable_prefix_cache=None),
    dict(prefill_chunk=4, enable_prefix_cache=False),
    dict(prefill_chunk=4, prefill_buckets=(16, 64)),
]


@pytest.mark.parametrize("kw", STRATEGY_CASES)
def test_strategy_resolves_as_jax(models, no_switches, kw):
    """The prefix cache with bucketed prefill, a largest bucket below
    max_model_len and a chunk beside buckets raise JAX's ValueError;
    otherwise chunk, buckets (sorted) and the prefix cache resolve to
    JAX's."""
    jm, tm = models
    base = dict(num_slots=2, block_size=4)
    got = _raised(lambda: GenerationEngine(tm, device="cpu", **base, **kw))
    want = _raised(lambda: JEngine(jm, attention_backend="dense", **base,
                                   **kw))
    assert got == want
    if want is None:
        teng = GenerationEngine(tm, device="cpu", **base, **kw)
        jeng = JEngine(jm, attention_backend="dense", **base, **kw)
        for name in ("prefill_chunk", "chunked_prefill", "prefill_buckets",
                     "enable_prefix_cache"):
            assert getattr(teng, name) == getattr(jeng, name), name


def _trace(seed=4):
    """Prompts of 1-40 tokens across the buckets 16, 32 and 64 (block 4),
    two of them repeated, mid-run arrivals."""
    rng = np.random.RandomState(seed)
    reqs = [(rng.randint(0, VOCAB, n).astype(np.int32), int(m)) for n, m in
            ((5, 6), (16, 4), (17, 7), (1, 5), (33, 3), (12, 8), (40, 6))]
    return reqs + [reqs[1], reqs[4]]


def _serve(eng, reqs, params=None):
    params = params or {}
    ids = [eng.add_request(p, n, sampling_params=params.get(i))
           for i, (p, n) in enumerate(reqs[:4])]
    eng.step()
    ids += [eng.add_request(p, n, sampling_params=params.get(4 + i))
            for i, (p, n) in enumerate(reqs[4:])]
    out = eng.run()
    return [list(map(int, out[r])) for r in ids]


@pytest.mark.parametrize("K,kv_dtype,weight_dtype,num_blocks", [
    (0, None, None, 64), (4, None, None, 64), (0, "int8", None, 64),
    (4, "int8", None, 64), (0, None, "int8", 64), (0, None, None, 14)])
def test_bucketed_engine_token_identical_to_jax(models, no_switches, K,
                                                kv_dtype, weight_dtype,
                                                num_blocks):
    """Greedy K=0 and K=4, int8 KV, int8 weights, and a pool of 13 usable
    blocks, where admissions stall on their blocks (`stalls["admit"]`)."""
    jm, tm = models
    kw = dict(num_slots=3, block_size=4, num_blocks=num_blocks,
              prefill_chunk=None, spec_decode_k=K, kv_dtype=kv_dtype,
              weight_dtype=weight_dtype)
    want = _serve(JEngine(jm, attention_backend="dense", **kw), _trace())
    teng = GenerationEngine(tm, device="cpu", **kw)
    assert not teng.chunked_prefill and teng.prefill_buckets == (16, 32, 64)
    got = _serve(teng, _trace())
    assert got == want
    assert teng.admissions == len(want) and teng.prefill_chunks == 0
    assert teng.prefill_first_tokens == len(want)
    assert (teng.stalls["admit"] > 0) == (num_blocks == 14)
    assert teng.cache.leak_check() == []
    if kv_dtype is None and num_blocks == 64:
        chunked = GenerationEngine(tm, device="cpu",
                                   **dict(kw, prefill_chunk=8))
        assert _serve(chunked, _trace()) == got


def test_sampled_bucketed_engine_draws_jax_tokens(models, no_switches):
    """Sampled lanes (the first token folds plen - 1, as the final chunk
    does) emit JAX's streams token for token beside greedy lanes."""
    jm, tm = models
    kw = dict(num_slots=3, block_size=4, num_blocks=64,
              prefill_buckets=(16, 64), sampling=True)
    spec = {0: (0.8, 0, 1.0, 5), 2: (1.0, 8, 0.9, 6), 5: (0.7, 0, 0.8, 9),
            6: (1.3, 4, 1.0, 2)}
    tp = {i: SamplingParams(temperature=t, top_k=k, top_p=p, seed=s)
          for i, (t, k, p, s) in spec.items()}
    jp = {i: JParams(temperature=t, top_k=k, top_p=p, seed=s)
          for i, (t, k, p, s) in spec.items()}
    want = _serve(JEngine(jm, attention_backend="dense", **kw), _trace(),
                  jp)
    teng = GenerationEngine(tm, device="cpu", **kw)
    got = _serve(teng, _trace(), tp)
    assert got == want
    assert teng.sampled_tokens > 0


def test_forward_prefill_reads_the_int8_snapshot(models, no_switches):
    """Bucketed prefill under int8 weights goes through `int8_linear`, four
    projections a layer; `generate()` keeps the live weights."""
    _, tm = models
    eng = GenerationEngine(tm, device="cpu", num_slots=2, block_size=4,
                           prefill_chunk=None, weight_dtype="int8")
    calls = int8_linear.plain_calls
    with torch.no_grad():
        h, ks, vs = tm.gpt.forward_prefill(torch.zeros((1, 16),
                                                       dtype=torch.int32),
                                           eng._qweights)
    assert int8_linear.plain_calls - calls == 4 * tm.config.num_layers
    assert tuple(ks.shape) == (2, 1, 16, 4, 8) and h.shape == (1, 16, 32)
    calls = int8_linear.plain_calls
    tm.generate(torch.arange(1, 6)[None], max_length=8, use_cache=True)
    assert int8_linear.plain_calls == calls
