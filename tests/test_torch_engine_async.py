"""The port's async engine core (the dispatch-ahead pipeline) against its
serial core and the JAX engine's async core.

The async core is a scheduling change, not a numerics change: over mixed
traces (mid-run admissions, a shared prefix served twice, motif prompts
the n-gram drafter hits) its tokens are the serial core's and JAX's async
engine's at K=0 and K=4, chunked and bucketed, with int8 KV, at mp 2 on a
virtual mesh, with sampled lanes and with adapters; its flight recorder
is JAX's async engine's, event for event (dispatches, completes, adapter
prefetches, evictions). The pipeline drains: a step in flight when
`drain()` is called, an EOS or a shed in mid-pipeline behave as in the
serial core. The drafter helper proposes the step thread's drafts, under
the step thread's torch state (`draft_thread_state`).
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.adapters import AdapterRegistry as JRegistry
from paddle_tpu.inference import GenerationEngine as JEngine
from paddle_tpu.inference import speculative as jspec
from paddle_tpu.inference.sampling import SamplingParams as JParams
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu_torch import (GenerationEngine, GPTConfig, GPTForCausalLM,
                              load_paddle_tpu_state)
from paddle_tpu_torch.adapters import AdapterRegistry
from paddle_tpu_torch.inference import SamplingParams
from paddle_tpu_torch.inference import speculative as tspec

VOCAB = 64


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


@pytest.fixture(scope="module")
def registries(models):
    """Adapters 1-3 in both packages, strong enough to move tokens."""
    cfg = models[1].config
    regs = JRegistry(cfg, max_rank=4), AdapterRegistry(cfg, max_rank=4)
    rng = np.random.RandomState(7)
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    for aid, r in enumerate((2, 3, 2), start=1):
        w = {site: [(rng.randn(r, i).astype(np.float32) * 0.3,
                     rng.randn(o, r).astype(np.float32) * 0.3)
                    for _ in range(L)]
             for site, (i, o) in (("qkv", (H, 3 * H)), ("out", (H, H)),
                                  ("fc1", (H, I)), ("fc2", (I, H)))}
        for reg in regs:
            reg.register(aid, w, scaling=0.5)
    return regs


@pytest.fixture(autouse=True)
def no_switches(monkeypatch):
    for var in ("PADDLE_SERVE_ASYNC", "PADDLE_SERVE_TRACING",
                "PADDLE_SPEC_DECODE_K", "PADDLE_SERVE_KV_DTYPE",
                "PADDLE_SERVE_MP", "PADDLE_SERVE_SAMPLING",
                "PADDLE_SERVE_WEIGHT_DTYPE",
                "PADDLE_PAGED_ATTENTION_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _trace(seed=11):
    rng = np.random.RandomState(seed)
    motif = rng.randint(0, VOCAB, 3).astype(np.int32)
    reqs = [(rng.randint(0, VOCAB, rng.randint(2, 13)).astype(np.int32),
             int(rng.randint(2, 7))) for _ in range(4)]
    reqs += [(np.tile(motif, 5).astype(np.int32), 6),
             (np.tile(motif, 3).astype(np.int32), 8)]
    shared = rng.randint(0, VOCAB, 8).astype(np.int32)
    reqs += [(np.concatenate([shared, rng.randint(0, VOCAB, 3)])
              .astype(np.int32), 4), (shared.copy(), 4)]
    return reqs


def _serve(eng, reqs, extra=None):
    """Half the trace, two steps (admissions land mid-pipeline), the
    rest, run; then the trace again on the warm cache. `extra(i)` is
    request i's add_request keywords."""
    def add(i, p, n):
        return eng.add_request(p, n, **(extra(i) if extra else {}))

    half = len(reqs) // 2
    ids = [add(i, p, n) for i, (p, n) in enumerate(reqs[:half])]
    eng.step()
    eng.step()
    ids += [add(half + i, p, n) for i, (p, n) in enumerate(reqs[half:])]
    out = eng.run()
    ids2 = [add(i, p, n) for i, (p, n) in enumerate(reqs)]
    out2 = eng.drain() if isinstance(eng, GenerationEngine) else eng.run()
    return [None if out[i] is None else list(map(int, out[i]))
            for i in ids] + [None if out2[i] is None
                             else list(map(int, out2[i])) for i in ids2]


def _flight(eng):
    return [{k: v for k, v in e.items() if k != "t_us"}
            for e in eng.dump_flight_recorder()]


def _sampled(pkg):
    return lambda i: {"sampling_params": None if i % 3 else pkg(
        temperature=0.8, top_k=20, top_p=0.9, seed=100 + i)}


CASES = {
    "chunked_k0": dict(),
    "chunked_k4": dict(spec_decode_k=4),
    "bucketed_k4": dict(prefill_chunk=None, prefill_buckets=(16, 64),
                        spec_decode_k=4),
    "kv8_k0": dict(kv_dtype="int8"),
    "mp2_k4": dict(mp_degree=2, spec_decode_k=4),
    "sampled_k4": dict(sampling=True, spec_decode_k=4),
    "adapters": dict(adapter_pool_pages=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_async_is_serial_and_jax_async(models, registries, case):
    """Per configuration: the port's async tokens are its serial core's
    and JAX's async engine's; the async flight recorder is JAX's (one
    dispatch ahead, every one completed; the same prefetches and
    evictions); the drafts match (the accept counters)."""
    jm, tm = models
    kw = dict(num_slots=3, block_size=4, num_blocks=40, **CASES[case])
    if "prefill_chunk" not in kw:
        kw["prefill_chunk"] = 8
    jextra = textra = None
    if kw.get("sampling"):
        jextra, textra = _sampled(JParams), _sampled(SamplingParams)
    if case == "adapters":
        ids = (1, 2, 0, 3, 0, 1, 3, 2)
        jextra = textra = lambda i: {"adapter_id": ids[i % len(ids)]}
    jeng = JEngine(jm, attention_backend="dense", async_core=True,
                   **({"adapters": registries[0]} if case == "adapters"
                      else {}), **kw)
    want = _serve(jeng, _trace(), jextra)
    engs = {}
    for mode in (False, True):
        engs[mode] = GenerationEngine(
            tm, device="cpu", async_core=mode,
            **({"adapters": registries[1]} if case == "adapters" else {}),
            **kw)
        assert _serve(engs[mode], _trace(), textra) == want, mode
    serial, eng = engs[False], engs[True]
    assert eng.async_core and not serial.async_core
    assert eng._inflight is None and eng._ahead is None
    assert _flight(eng) == _flight(jeng)
    events = [e["event"] for e in _flight(eng)]
    assert events.count("async_dispatch") == events.count(
        "async_complete") == eng.decode_steps == serial.decode_steps
    if kw.get("spec_decode_k"):
        assert (eng.spec_accepted_tokens, eng.spec_rejected_tokens) == (
            serial.spec_accepted_tokens, serial.spec_rejected_tokens)
        assert eng.spec_accepted_tokens > 0
    if case == "adapters":
        assert "adapter_prefetch" in events
        assert eng.adapter_evictions == serial.adapter_evictions > 0
        assert eng.adapter_pool.leak_check() == []


def test_async_pipeline_never_runs_two_steps_deep(models):
    _, tm = models
    eng = GenerationEngine(tm, device="cpu", num_slots=3, block_size=4,
                           prefill_chunk=8, spec_decode_k=4,
                           async_core=True, flight_capacity=4096)
    _serve(eng, _trace(4))
    outstanding, seen = None, 0
    for e in eng.dump_flight_recorder():
        if e["event"] == "async_dispatch":
            assert outstanding is None and e["seq"] == seen + 1
            outstanding = seen = e["seq"]
        elif e["event"] == "async_complete":
            assert outstanding == e["seq"]
            outstanding = None
    assert outstanding is None and seen > 2


@pytest.mark.parametrize("value,want", [
    (None, False), ("1", True), ("off", False), ("", True),
    ("maybe", ValueError)])
def test_async_switch_resolves_as_in_jax(models, no_switches, value, want):
    """Off by default; `PADDLE_SERVE_ASYNC` wins over the argument, the
    empty string is unset, a bad value raises JAX's ValueError."""
    jm, tm = models
    if value is not None:
        no_switches.setenv("PADDLE_SERVE_ASYNC", value)
    kw = dict(num_slots=2, block_size=4, async_core=value == "")
    if want is ValueError:
        with pytest.raises(ValueError) as te:
            GenerationEngine(tm, device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            JEngine(jm, attention_backend="dense", **kw)
        assert str(te.value) == str(je.value)
        return
    assert GenerationEngine(tm, device="cpu", **kw).async_core is \
        JEngine(jm, attention_backend="dense", **kw).async_core is want


def test_serial_core_engages_no_pipeline_state(models):
    _, tm = models
    eng = GenerationEngine(tm, device="cpu", num_slots=2, block_size=4,
                           prefill_chunk=8, spec_decode_k=4)
    _serve(eng, _trace(3)[:4])
    assert eng._inflight is None and eng._ahead is None
    assert not {e["event"] for e in eng.dump_flight_recorder()} & {
        "async_dispatch", "async_complete", "adapter_prefetch"}


def test_drain_completes_the_step_in_flight(models):
    _, tm = models
    reqs = _trace(9)

    def serve(async_core):
        eng = GenerationEngine(tm, device="cpu", num_slots=3, block_size=4,
                               num_blocks=64, prefill_chunk=8,
                               spec_decode_k=4, async_core=async_core)
        ids = [eng.add_request(p, n) for p, n in reqs]
        for _ in range(16):
            eng.step()
            if async_core and eng._inflight is not None:
                break
        assert eng._inflight is not None or not async_core
        out = eng.drain()              # the leak audits raise on a leak
        assert eng._inflight is None and eng._ahead is None
        return [out[i] for i in ids]

    assert serve(True) == serve(False)


def test_eos_mid_pipeline_truncates_as_serial(models):
    jm, tm = models
    rng = np.random.RandomState(5)
    motif = rng.randint(0, VOCAB, 3).astype(np.int32)
    reqs = [(np.tile(motif, 4).astype(np.int32), 12),
            (rng.randint(0, VOCAB, 7).astype(np.int32), 12)]

    def serve(eng, eos):
        ids = [eng.add_request(p, n, eos_token_id=eos) for p, n in reqs]
        out = eng.run()
        return [list(map(int, out[i])) for i in ids]

    kw = dict(num_slots=2, block_size=4, num_blocks=64, prefill_chunk=8,
              spec_decode_k=4)
    base = serve(GenerationEngine(tm, device="cpu", **kw), None)
    eos = base[0][len(reqs[0][0]) + 1]
    serial = serve(GenerationEngine(tm, device="cpu", **kw), eos)
    amode = serve(GenerationEngine(tm, device="cpu", async_core=True, **kw),
                  eos)
    assert amode == serial == serve(
        JEngine(jm, attention_backend="dense", async_core=True, **kw), eos)
    assert any(len(a) < len(b) for a, b in zip(serial, base))


def test_shed_mid_run_as_serial(models):
    _, tm = models
    rng = np.random.RandomState(13)
    reqs = [(rng.randint(0, VOCAB, rng.randint(3, 10)).astype(np.int32), 4)
            for _ in range(8)]

    def serve(async_core):
        eng = GenerationEngine(tm, device="cpu", num_slots=2, block_size=4,
                               num_blocks=64, prefill_chunk=8, max_queue=2,
                               async_core=async_core)
        ids = [eng.add_request(p, n, priority="batch") for p, n in reqs]
        out = eng.run()
        return [out[i] for i in ids], eng.shed

    (a, shed_a), (s, shed_s) = serve(True), serve(False)
    assert a == s and shed_a == shed_s > 0


# -- the drafter helper -------------------------------------------------------

class _ListDrafter:
    def __init__(self, tokens):
        self.tokens = list(tokens)

    def propose(self, prompt, generated, budget):
        return list(self.tokens)


@pytest.mark.parametrize("proposal,budget", [
    ([3, 5, 7], 3), ([3, 5, 7, 9], 2), ([3, 64, 7], 3), ([3, -1, 7], 3),
    ([64, 3, 5], 3), ([3, 5], 0), ([3, 5], -2), ([], 4),
    (np.array([3, 5], dtype=np.int32), 2)])
def test_draft_window_is_jax_s(proposal, budget):
    got = tspec.draft_window(_ListDrafter(proposal), [1, 2], [0], budget,
                             VOCAB)
    assert got == jspec.draft_window(_ListDrafter(proposal), [1, 2], [0],
                                     budget, VOCAB)
    assert all(type(t) is int for t in got)


def test_gpt_drafter_on_the_helper_thread_proposes_the_step_thread_s():
    """`draft_thread_state` captured on the step thread turns grad off on
    the helper thread (a new thread starts with grad on) and the
    proposals there are the step thread's; an async engine with the
    GPT drafter serves the serial engine's tokens."""
    torch.manual_seed(1)
    draft = GPTForCausalLM(GPTConfig.tiny(vocab=VOCAB, hidden=16,
                                          layers=1, heads=2, seq=64),
                           device="cpu").eval()
    drafter = tspec.GptDrafter(draft)
    prompt, gen = np.arange(9, dtype=np.int32) % 7, [3, 4]
    want = tspec.draft_window(drafter, prompt, gen, 4, VOCAB)
    state = tspec.draft_thread_state(drafter)
    seen = {}

    def work():
        seen["grad_before"] = torch.is_grad_enabled()
        with state():
            seen["grad"] = torch.is_grad_enabled()
            seen["draft"] = tspec.draft_window(drafter, prompt, list(gen),
                                               4, VOCAB)

    th = threading.Thread(target=work)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    assert seen == {"grad_before": True, "grad": False, "draft": want}
    target = GPTForCausalLM(GPTConfig.tiny(vocab=VOCAB, hidden=32, layers=2,
                                           heads=4, seq=64),
                            device="cpu").eval()
    outs = []
    for mode in (False, True):
        eng = GenerationEngine(target, device="cpu", num_slots=2,
                               block_size=4, prefill_chunk=8,
                               spec_decode_k=2, drafter=drafter,
                               async_core=mode)
        outs.append(_serve(eng, _trace(2)[:4]))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kw", [dict(), dict(async_core=True, tracing=True,
                                             spec_decode_k=2)],
                         ids=["serial", "async_traced"])
def test_a_dropped_engine_is_freed_at_once(models, kw):
    """No reference cycle runs through the engine (the prefix cache's
    eviction hook holds the flight recorder, not the engine): the last
    reference gone, the engine and its pools go at once, without a
    garbage collection, so a card gets its memory back."""
    import gc
    import weakref

    _, tm = models
    eng = GenerationEngine(tm, device="cpu", num_slots=2, block_size=4,
                           num_blocks=12, prefill_chunk=8, **kw)
    _serve(eng, _trace(8)[:4])
    gone = weakref.ref(eng), weakref.ref(eng.cache.kpool)
    gc.disable()
    try:
        del eng
        assert [r() for r in gone] == [None, None]
    finally:
        gc.enable()
