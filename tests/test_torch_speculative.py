"""Speculative decoding of the PyTorch port against the JAX package.

Drafters: `NgramDrafter` and `draft_window` propose JAX's tokens on seeded
contexts; `GptDrafter` over a tiny GPT carried across by the weight bridge
proposes JAX's tokens.

Engine: on a tiny f32 GPT with K=2 and K=3, under the n-gram drafter and an
oracle drafter (it proposes the K=0 continuation, so whole windows are
accepted), the port's engine emits the JAX engine's tokens
(`attention_backend="dense"`), with the same accepted and rejected draft
counts, and the port's own K=0 tokens. An oversubscribed pool makes a lane
shed its draft and the surplus tail blocks instead of deadlocking
(tests/test_engine_speculative.py
`test_spec_cow_pressure_sheds_draft_instead_of_deadlocking`).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationEngine as JEngine
from paddle_tpu.inference import speculative as jspec
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu_torch import (GenerationEngine, GPTConfig, GPTForCausalLM,
                              load_paddle_tpu_state)
from paddle_tpu_torch.inference import speculative as tspec
from paddle_tpu_torch.ops.paged_decode import paged_decode_attention
from paddle_tpu_torch.ops.paged_verify import paged_verify_attention

VOCAB = 61


def _pair(seed, **kw):
    paddle.seed(seed)
    cfg = dict(vocab=VOCAB, hidden=32, layers=2, heads=2, seq=64)
    cfg.update(kw)
    jm = JGPT(JConfig.tiny(**cfg))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig.tiny(**cfg), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v._array)
                               for k, v in jm.state_dict().items()})
    return jm, tm.eval()


@pytest.fixture(scope="module")
def models():
    return _pair(0)


def _contexts(seed, n=40):
    """Prompts that tile short motifs (so n-grams recur), plain random
    ones, and generated tails of 0-6 tokens."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        if i % 2:
            motif = rng.randint(0, 6, rng.randint(1, 5))
            prompt = np.tile(motif, rng.randint(1, 5))[:rng.randint(1, 12)]
        else:
            prompt = rng.randint(0, 8, rng.randint(1, 10))
        gen = list(rng.randint(0, 8, rng.randint(0, 7)))
        out.append((prompt.astype(np.int32), gen))
    return out


@pytest.mark.parametrize("max_ngram,min_ngram", [(3, 1), (2, 2), (4, 1)])
@pytest.mark.parametrize("k", [0, 1, 4])
def test_ngram_drafter_proposes_jax_tokens(max_ngram, min_ngram, k):
    t = tspec.NgramDrafter(max_ngram, min_ngram)
    j = jspec.NgramDrafter(max_ngram, min_ngram)
    hits = 0
    for prompt, gen in _contexts(max_ngram * 10 + k):
        got = t.propose(prompt, gen, k)
        assert got == j.propose(prompt, gen, k)
        hits += bool(got)
    assert hits > 0 or k == 0
    with pytest.raises(ValueError, match="min_ngram"):
        tspec.NgramDrafter(1, 0)


def test_draft_window_filters_like_jax():
    class Junk:
        def __init__(self, toks):
            self.toks = toks

        def propose(self, prompt, generated, k):
            return self.toks

    for toks in ([3, 4, 5, 6], [3, VOCAB, 4], [-1, 2], [], [7, 8]):
        for budget in (0, 2, 3):
            d = Junk(toks)
            assert tspec.draft_window(d, [1], [], budget, VOCAB) == \
                jspec.draft_window(d, [1], [], budget, VOCAB)


def test_gpt_drafter_proposes_jax_tokens():
    jm, tm = _pair(3, vocab=VOCAB, hidden=16, layers=1, heads=2, seq=16)
    t = tspec.GptDrafter(tm, max_context=12)
    j = jspec.GptDrafter(jm, max_context=12)
    for prompt, gen in _contexts(5, n=2):
        assert t.propose(prompt, gen, 3) == j.propose(prompt, gen, 3)
    assert t.propose([VOCAB + 1], [], 3) == []     # foreign id space
    with pytest.raises(ValueError, match="max_context"):
        tspec.GptDrafter(tm, max_context=17)


class OracleDrafter:
    """Proposes the K=0 engine's continuation: every window is accepted
    whole (the exact-acceptance contract from the other side)."""

    def __init__(self, prompts, outputs):
        self.ref = {bytes(np.asarray(p, np.int32)): list(o)
                    for p, o in zip(prompts, outputs)}

    def propose(self, prompt, generated, k):
        out = self.ref[bytes(np.asarray(prompt, np.int32))]
        n = len(prompt) + len(generated)
        return out[n:n + k]


def _trace(seed):
    """Motif-tiled prompts (the n-gram drafter hits), random ones, an EOS
    stop, and a block-aligned prompt served twice (a full-prefix hit whose
    first window takes a copy-on-write)."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(6):
        if i % 2:
            motif = rng.randint(0, VOCAB, rng.randint(2, 5))
            p = np.tile(motif, 4)[:rng.randint(6, 14)]
        else:
            p = rng.randint(0, VOCAB, rng.randint(2, 12))
        reqs.append((p.astype(np.int32), int(rng.randint(3, 12)), {}))
    shared = rng.randint(0, VOCAB, 8).astype(np.int32)
    reqs += [(shared, 6, {}), (shared.copy(), 7, {})]
    return reqs


def _serve(eng, reqs):
    ids = [eng.add_request(p, n, **e) for p, n, e in reqs[:4]]
    for _ in range(2):
        eng.step()
    ids += [eng.add_request(p, n, **e) for p, n, e in reqs[4:-1]]
    out = eng.run()
    ids.append(eng.add_request(reqs[-1][0], reqs[-1][1], **reqs[-1][2]))
    out.update(eng.run())
    return [list(out[i]) for i in ids]


@pytest.fixture(scope="module")
def plain_run(models):
    """The port's K=0 tokens on the trace, one EOS stop added."""
    _, tm = models
    reqs = _trace(21)
    kw = dict(num_slots=3, block_size=4, num_blocks=48, prefill_chunk=8)
    base = _serve(GenerationEngine(tm, device="cpu", **kw), reqs)
    p, n, _ = reqs[1]
    reqs[1] = (p, n, {"eos_token_id": base[1][len(p) + 2]})
    base = _serve(GenerationEngine(tm, device="cpu", **kw), reqs)
    return reqs, base, kw


@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("drafter", ["ngram", "oracle"])
def test_spec_engine_token_identical_to_jax_and_to_k0(models, plain_run, K,
                                                      drafter):
    jm, tm = models
    reqs, base, kw = plain_run
    make = (lambda: None) if drafter == "ngram" else \
        (lambda: OracleDrafter([p for p, _, _ in reqs], base))
    jeng = JEngine(jm, attention_backend="dense", spec_decode_k=K,
                   drafter=make(), **kw)
    teng = GenerationEngine(tm, device="cpu", spec_decode_k=K,
                            drafter=make(), **kw)
    launches = paged_verify_attention.launches
    plain = paged_verify_attention.plain_calls
    decode = paged_decode_attention.plain_calls
    want = _serve(jeng, reqs)
    got = _serve(teng, reqs)
    assert got == want == base
    assert got[1][-1] == reqs[1][2]["eos_token_id"]
    assert (teng.spec_accepted_tokens, teng.spec_rejected_tokens) == (
        jeng._m_spec_ok.value, jeng._m_spec_rej.value)
    assert teng.spec_accepted_tokens > 0
    if drafter == "oracle":
        assert teng.spec_rejected_tokens == 0
    assert teng.prefix_hit_tokens == jeng.prefix_hit_tokens > 0
    assert teng.cow_copies >= 1 and teng.cache.leak_check() == []
    # with K > 0 the verify step IS the decode step, on CPU its plain
    # version: once per layer a step
    assert paged_verify_attention.launches == launches
    assert paged_verify_attention.plain_calls == plain \
        + 2 * teng.decode_steps
    assert paged_decode_attention.plain_calls == decode
    assert teng.tokens_generated == sum(len(g) - len(p) for g, (p, _, _)
                                        in zip(got, reqs))


def test_spec_cow_pressure_sheds_draft_instead_of_deadlocking(models):
    """4 blocks of 4 tokens, one lane, a drafter that always fills the
    window: the second serve seats both cached prompt blocks, the window
    takes the last free block, and the COW copy of the feed block then
    has nothing left, so the lane sheds its draft and the tail block and
    runs a one-token window, as the JAX engine does."""
    jm, tm = models

    class FullDrafter:
        def propose(self, prompt, generated, k):
            return [0] * k

    prompt = np.random.RandomState(5).randint(0, VOCAB, 8).astype(np.int32)
    kw = dict(num_slots=1, block_size=4, num_blocks=4, prefill_chunk=8,
              spec_decode_k=4, drafter=FullDrafter())
    jeng = JEngine(jm, attention_backend="dense", **kw)
    teng = GenerationEngine(tm, device="cpu", **kw)
    outs = []
    for eng in (jeng, teng):
        served = []
        for _ in range(2):             # the second serve is the full hit
            rid = eng.add_request(prompt, 4)
            served.append(eng.run()[rid])
        outs.append(served)
    assert [list(o) for o in outs[1]] == [list(o) for o in outs[0]]
    want = tm.generate(torch.from_numpy(prompt)[None], max_length=12,
                       use_cache=True)[0].tolist()
    assert list(outs[1][1]) == want
    snap = jeng.metrics_snapshot()
    jstalls = {s["labels"]["path"]: s["value"]
               for s in snap["engine_block_stalls_total"]["series"]}
    assert teng.stalls["spec_degrade"] == jstalls["spec_degrade"] >= 1
    assert teng.stalls["decode"] == jstalls.get("decode", 0) == 0
    assert teng.cow_copies >= 1
    assert teng.cache.num_free == teng.cache.num_blocks - 1


def test_spec_decode_k_validation(models):
    _, tm = models
    with pytest.raises(ValueError, match="spec_decode_k"):
        GenerationEngine(tm, device="cpu", spec_decode_k=-1)
    eng = GenerationEngine(tm, device="cpu", spec_decode_k=2)
    assert isinstance(eng.drafter, tspec.NgramDrafter)
    assert GenerationEngine(tm, device="cpu").drafter is None
