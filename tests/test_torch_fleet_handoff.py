"""The disaggregated handoff of the port's serving fleet against the JAX
package's: the block transfer ops, the engine's handoff surface and the
prefill/decode pair.

`export_pool_block`/`ingest_pool_block` are held bitwise to JAX's (jitted)
on fp and int8 pools, scale rows included, and the head-sharded editions to
the one-shard call. A disaggregated pair (1 prefill + 1 decode replica)
serves JAX's pair's tokens and its colocated engine's at fp and int8 pools,
chunked and bucketed, at mp 2 on a virtual CPU mesh (JAX on the forced host
devices of tests/conftest.py) and with seeded sampled lanes; each replica's
flight recorder is JAX's. The prefill replica never decodes, `adopt_request`
refuses what JAX refuses, `drain()` refuses a parked handoff, a reused
`req_id` collides with one, a request finished at its first token exports
nothing, and a source block reused before its payload is placed does not
reach the payload (the export is a copy). The fleet's trace is one timeline:
route spans with the affinity arguments, handoff spans under the request's
trace id.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingFleet as JFleet
from paddle_tpu.inference.sampling import SamplingParams as JParams
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch import (GenerationEngine, GPTConfig, GPTForCausalLM,
                              load_paddle_tpu_state)
from paddle_tpu_torch.inference import SamplingParams, ServingFleet
from paddle_tpu_torch.observability import series_total
from paddle_tpu_torch.ops.paged_attention import (export_pool_block,
                                                  export_pool_block_shards,
                                                  ingest_pool_block,
                                                  ingest_pool_block_shards)

VOCAB = 61


def _pair(vocab):
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
    return _pair(VOCAB)


@pytest.fixture(scope="module")
def models_even():
    """The same sizes at vocab 62: mp 2 shards the vocabulary rows."""
    return _pair(VOCAB + 1)


@pytest.fixture(autouse=True)
def no_switches(monkeypatch):
    for var in ("PADDLE_SERVE_TRACING", "PADDLE_SERVE_ASYNC",
                "PADDLE_SPEC_DECODE_K", "PADDLE_SERVE_KV_DTYPE",
                "PADDLE_SERVE_MP", "PADDLE_SERVE_SAMPLING",
                "PADDLE_SERVE_WEIGHT_DTYPE",
                "PADDLE_PAGED_ATTENTION_BACKEND"):
        monkeypatch.delenv(var, raising=False)


# -- the transfer unit --------------------------------------------------------

def _pools(int8, seed=0, L=2, nb=6, bs=4, H=4, D=8):
    rng = np.random.RandomState(seed)
    if int8:
        k, v = (rng.randint(-127, 128, (L, nb, bs, H, D)).astype(np.int8)
                for _ in range(2))
        sc = rng.rand(L, nb, 2).astype(np.float32) + 0.01
        return k, v, sc
    k, v = (rng.randn(L, nb, bs, H, D).astype(np.float32) for _ in range(2))
    return k, v, None


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_export_ingest_bitwise_jax(int8):
    k, v, sc = _pools(int8)
    dk, dv, dsc = _pools(int8, seed=1)
    src, dst = 3, 5
    jexp, jing = jax.jit(jpa.export_pool_block), jax.jit(
        jpa.ingest_pool_block)
    jargs = () if sc is None else (jnp.asarray(sc),)
    want = jexp(jnp.asarray(k), jnp.asarray(v), jnp.int32(src), *jargs)
    tk, tv = _t(k), _t(v)
    tsc = None if sc is None else _t(sc)
    got = export_pool_block(tk, tv, src, tsc)
    assert len(got) == len(want) == (3 if int8 else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a copy: the source block rewritten after the export leaves it alone
    before = [g.clone() for g in got]
    tk[:, src] = 0
    tv[:, src] = 0
    if tsc is not None:
        tsc[:, src] = 7.0
    assert all(torch.equal(g, b) for g, b in zip(got, before))
    jdst = [jnp.asarray(dk), jnp.asarray(dv)]
    if int8:
        want_pools = jing(*jdst, want[0], want[1], jnp.int32(dst),
                          jnp.asarray(dsc), want[2])
    else:
        want_pools = jing(*jdst, want[0], want[1], jnp.int32(dst))
    pools = [_t(dk), _t(dv)] + ([] if dsc is None else [_t(dsc)])
    back = ingest_pool_block(pools[0], pools[1], got[0], got[1], dst,
                             *((pools[2], got[2]) if int8 else ()))
    assert all(b is p for b, p in zip(back, pools))       # in place
    for p, w in zip(pools, want_pools):
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_shard_editions_are_the_one_shard_call_split(int8):
    """Head-sharded pools at mp 2: each shard's rows move to the same shard,
    the scale row reaches every replica of the grid."""
    k, v, sc = _pools(int8)
    dk, dv, dsc = _pools(int8, seed=1)
    whole = export_pool_block(_t(k), _t(v), 2,
                              None if sc is None else _t(sc))
    ks, vs = list(_t(k).chunk(2, dim=3)), list(_t(v).chunk(2, dim=3))
    ks = [x.contiguous() for x in ks]
    vs = [x.contiguous() for x in vs]
    scs = None if sc is None else [_t(sc), _t(sc)]
    parts = export_pool_block_shards(ks, vs, 2, scs)
    assert torch.equal(torch.cat(parts[0], dim=2), whole[0])
    assert torch.equal(torch.cat(parts[1], dim=2), whole[1])
    if int8:
        assert torch.equal(parts[2], whole[2])
    ref = [_t(dk), _t(dv)] + ([] if dsc is None else [_t(dsc)])
    ingest_pool_block(ref[0], ref[1], whole[0], whole[1], 4,
                      *((ref[2], whole[2]) if int8 else ()))
    dks = [x.contiguous() for x in _t(dk).chunk(2, dim=3)]
    dvs = [x.contiguous() for x in _t(dv).chunk(2, dim=3)]
    dscs = None if dsc is None else [_t(dsc), _t(dsc)]
    ingest_pool_block_shards(dks, dvs, parts[0], parts[1], 4, dscs,
                             parts[2] if int8 else None)
    assert torch.equal(torch.cat(dks, dim=3), ref[0])
    assert torch.equal(torch.cat(dvs, dim=3), ref[1])
    if int8:
        assert all(torch.equal(s, ref[2]) for s in dscs)


# -- the disaggregated pair ---------------------------------------------------

def _mixed_trace(rng, n=6):
    prios = ("interactive", "standard", "batch")
    return [(rng.randint(0, VOCAB, int(rng.randint(3, 40))),
             int(rng.randint(2, 10)), prios[i % 3])
            for i in range(n)]


def _fleet(models, pkg, **kw):
    jm, tm = models
    kw.setdefault("num_slots", 4)
    kw.setdefault("block_size", 8)
    if pkg == "jax":
        return JFleet(jm, attention_backend="dense", **kw)
    return ServingFleet(tm, device="cpu", **kw)


def _serve(fleet, trace, eos=5, params=None):
    ids = [fleet.add_request(p, max_new_tokens=n, priority=pr,
                             eos_token_id=eos,
                             sampling_params=None if params is None
                             else params(i))
           for i, (p, n, pr) in enumerate(trace)]
    out = fleet.run()
    return [list(map(int, out[i])) for i in ids]


def _colocated(models, trace, eos=5, params=None, **kw):
    kw.setdefault("num_slots", 4)
    eng = GenerationEngine(models[1], device="cpu", block_size=8, **kw)
    ids = [eng.add_request(p, max_new_tokens=n, priority=pr,
                           eos_token_id=eos,
                           sampling_params=None if params is None
                           else params(i))
           for i, (p, n, pr) in enumerate(trace)]
    out = eng.run()
    return [list(map(int, out[i])) for i in ids]


def _flight(eng):
    return [{k: v for k, v in e.items() if k != "t_us"}
            for e in eng.dump_flight_recorder()]


PAIR = dict(num_replicas=1, num_prefill_replicas=1)
CASES = {"fp_chunked": dict(), "int8_chunked": dict(kv_dtype="int8"),
         "fp_bucketed": dict(prefill_buckets=(16, 64)),
         "int8_bucketed": dict(kv_dtype="int8", prefill_buckets=(16, 64)),
         "fp_chunked_mp2": dict(mp_degree=2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_disaggregated_pair_serves_jax_s_tokens(request, case):
    kw = CASES[case]
    models = request.getfixturevalue(
        "models_even" if "mp_degree" in kw else "models")
    trace = _mixed_trace(np.random.RandomState(2))
    jf, tf = _fleet(models, "jax", **PAIR, **kw), _fleet(models, "torch",
                                                          **PAIR, **kw)
    want = _serve(jf, trace)
    got = _serve(tf, trace)
    assert got == want
    assert got == _colocated(models, trace, **kw)
    js, ts = jf.metrics_snapshot(), tf.metrics_snapshot()
    for name in ("fleet_handoffs_total", "fleet_handoff_blocks_total",
                 "fleet_handoff_stalls_total", "fleet_routed_total"):
        assert series_total(ts, name) == series_total(js, name), name
    assert series_total(ts, "fleet_handoffs_total") == len(trace)
    for jr, tr in zip(jf._replicas.values(), tf._replicas.values()):
        assert tr.role == jr.role
        assert _flight(tr.engine) == _flight(jr.engine), tr.role
        assert tr.engine.mp_degree == jr.engine.mp_degree
    tf.drain()


def test_disaggregated_sampled_streams_equal_colocated_and_jax(models):
    """The seed travels with the handoff (resolved at the fleet's intake
    when None): the adopted lane carries the colocated lane's key row."""
    trace = _mixed_trace(np.random.RandomState(6))

    def params(cls):
        def of(i):
            if i == 2:
                return None                       # a greedy lane
            return cls(temperature=0.9, top_k=20, top_p=0.9,
                       seed=None if i == 4 else 300 + i)
        return of
    got = _serve(_fleet(models, "torch", sampling=True, **PAIR), trace,
                 params=params(SamplingParams))
    assert got == _serve(_fleet(models, "jax", sampling=True, **PAIR),
                         trace, params=params(JParams))
    assert got == _colocated(models, trace, sampling=True,
                             params=params(SamplingParams))


def test_prefill_replica_never_decodes(models):
    trace = _mixed_trace(np.random.RandomState(3), n=5)
    fleet = _fleet(models, "torch", **PAIR)
    _serve(fleet, trace, eos=None)
    roles = {r.role: r.engine for r in fleet._replicas.values()}
    pre, dec = roles["prefill"], roles["decode"]
    assert pre.tokens_generated == 5 and pre.decode_steps == 0
    fin = {s["labels"]["reason"]: s["value"] for s in
           pre.metrics.snapshot()["engine_finished_total"]["series"]}
    assert fin == {"handoff": 5}
    assert dec.prefill_chunks == 0 and series_total(
        dec.metrics.snapshot(), "engine_prefill_chunks_total") == 0
    assert dec.tokens_generated == sum(n for _, n, _ in trace) - 5


def _port_engine(models, **kw):
    return GenerationEngine(models[1], device="cpu", block_size=8, **kw)


def test_adopt_request_validations(models):
    eng = _port_engine(models, num_slots=1)
    blocks = eng.cache.allocate(2)
    with pytest.raises(ValueError, match="exactly"):
        eng.adopt_request(np.arange(10), 3, blocks[:1], 4)
    eng.add_request(np.arange(12) % VOCAB, max_new_tokens=8)
    eng.step()
    assert eng.free_lanes == 0
    with pytest.raises(RuntimeError, match="free lane"):
        eng.adopt_request(np.arange(10) % VOCAB, 3, blocks, 4)
    eng.cache.free(blocks)
    eng.run()
    # sampled requests need their seed resolved before the handoff
    seng = _port_engine(models, num_slots=2, sampling=True)
    with pytest.raises(ValueError, match="explicit seed"):
        seng.adopt_request(np.arange(10) % VOCAB, 3,
                           seng.cache.allocate(2), 4,
                           sampling_params=SamplingParams(temperature=1.0))
    with pytest.raises(ValueError, match="sampling=True"):
        eng.adopt_request(np.arange(10) % VOCAB, 3, [1, 2], 4,
                          sampling_params=SamplingParams(temperature=1.0,
                                                         seed=1))
    with pytest.raises(ValueError, match="adapters="):
        eng.adopt_request(np.arange(10) % VOCAB, 3, [1, 2], 4,
                          adapter_id=1)
    # complete on arrival (EOS, or a budget of 1): retired at once, the
    # first token not counted again
    for kw in (dict(eos_token_id=3), dict()):
        got = eng.cache.allocate(2)
        rid = eng.adopt_request(np.arange(10) % VOCAB, 3, got,
                                4 if kw else 1, **kw)
        assert eng.free_lanes == 1
        assert eng.pop_results()[rid][-1] == 3
    assert eng.tokens_generated == 8            # the one request's tokens
    eng.drain()
    with pytest.raises(RuntimeError, match="draining"):
        eng.adopt_request([1, 2], 3, [1], 2)


def test_adopted_lane_decodes_as_the_prefill_would_have(models):
    """Adoption by hand: the prefill-only engine's parked blocks copied
    into a second engine's pool, the lane adopted, the rest of the budget
    decoded: the colocated engine's tokens."""
    p = np.random.RandomState(4).randint(0, VOCAB, 21)
    ref = _port_engine(models, num_slots=2)
    ref_id = ref.add_request(p, 6)
    want = ref.run()[ref_id]
    pre = _port_engine(models, num_slots=2)
    rid = pre.add_request(p, 1, prefill_only=True)
    first = pre.run()[rid][-1]
    blocks, hit = pre.take_handoff(rid)
    assert hit == 0 and len(blocks) == 3
    dec = _port_engine(models, num_slots=2)
    dst = dec.cache.allocate(len(blocks))
    c = pre.cache
    for b, d in zip(blocks, dst):
        ingest_pool_block(dec.cache.kpool, dec.cache.vpool,
                          *export_pool_block(c.kpool, c.vpool, b), d)
    pre.release_handoff(blocks)
    dec.adopt_request(p, first, dst, 6, req_id="r")
    got = dec.run()["r"]
    assert got == want
    assert dec.tokens_generated == 5
    pre.drain()
    dec.drain()


def test_prefill_only_needs_a_budget_of_one(models):
    eng = _port_engine(models, num_slots=2)
    with pytest.raises(ValueError, match="prefill_only requests carry"):
        eng.add_request([1, 2, 3], 4, prefill_only=True)


def test_drain_refuses_a_parked_handoff(models):
    eng = _port_engine(models, num_slots=2)
    rid = eng.add_request(np.arange(10) % VOCAB, max_new_tokens=1,
                          prefill_only=True)
    with pytest.raises(RuntimeError, match="handoff"):
        eng.drain()
    blocks, _ = eng.take_handoff(rid)
    eng.release_handoff(blocks)
    assert eng.cache.leak_check() == []


def test_reused_req_id_collides_with_a_parked_handoff(models):
    eng = _port_engine(models, num_slots=2)
    rid = eng.add_request(np.arange(10) % VOCAB, max_new_tokens=1,
                          prefill_only=True)
    eng.run()                            # result collected, handoff parked
    with pytest.raises(ValueError, match="already"):
        eng.add_request(np.arange(10) % VOCAB, max_new_tokens=1,
                        prefill_only=True, req_id=rid)
    assert eng.add_request([1, 2], 1) != rid    # auto ids skip it too
    eng.run()
    blocks, _ = eng.take_handoff(rid)
    eng.release_handoff(blocks)
    assert eng.cache.leak_check() == []


def test_request_done_at_its_first_token_exports_nothing(models):
    """Fleet-level EOS: a first token equal to EOS, or a budget of 1, ends
    the request on the prefill replica; its blocks are released and no
    payload is exported."""
    p = np.random.RandomState(11).randint(0, VOCAB, 19)
    first = _colocated(models, [(p, 2, "standard")], eos=None)[0][len(p)]
    trace = [(p, 6, "standard"), (p[:13], 1, "batch")]
    outs = []
    for pkg in ("torch", "jax"):
        fleet = _fleet(models, pkg, **PAIR)
        outs.append(_serve(fleet, trace, eos=first))
        snap = fleet.metrics_snapshot()
        assert series_total(snap, "fleet_handoffs_total") == 0
        assert series_total(snap, "fleet_handoff_blocks_total") == 0
        assert fleet._pending_handoffs == []
        if pkg == "torch":
            for rep in fleet._replicas.values():
                assert rep.engine._handoffs == {}
            fleet.drain()
    assert outs[0] == outs[1]
    assert outs[0][0] == list(map(int, p)) + [first]
    assert len(outs[0][1]) == 14


def test_source_block_reused_before_placement_spares_the_payload(models):
    """A full prefill pool: one lane and just the blocks one request needs
    on every replica (no prefix cache: freed blocks go straight back to the
    free list), so the next prompt prefills into the blocks the last export
    released while that payload still waits for the decode lane. The
    payload is a copy: at adoption each request's ingested rows are its
    own prompt's KV, and its tokens the colocated engine's."""
    rng = np.random.RandomState(12)
    trace = [(rng.randint(0, VOCAB, 16), 16, "standard") for _ in range(3)]
    kw = dict(num_slots=1, num_blocks=5,            # 4 blocks + block 0
              enable_prefix_cache=False)
    fleet = _fleet(models, "torch", **PAIR, **kw)
    roles = {r.role: r.engine for r in fleet._replicas.values()}
    pre, dec = roles["prefill"], roles["decode"]
    taken, ingested = [], {}
    take, adopt = pre.take_handoff, dec.adopt_request

    def recorded_take(rid):
        blocks, hit = take(rid)
        taken.append(sorted(blocks))
        return blocks, hit

    def recorded_adopt(prompt, first, blocks, *a, **kw):
        c = dec.cache
        ingested[kw["req_id"]] = [export_pool_block(c.kpool, c.vpool, b)
                                  for b in blocks]
        return adopt(prompt, first, blocks, *a, **kw)
    pre.take_handoff, dec.adopt_request = recorded_take, recorded_adopt
    got = _serve(fleet, trace, eos=None)
    del pre.take_handoff, dec.adopt_request
    assert len(taken) == 3 and taken[0] == taken[1] == taken[2]
    assert series_total(fleet.metrics_snapshot(),
                        "fleet_handoff_stalls_total") > 0
    # each prompt's own KV, from a prefill-only run on a fresh engine
    ref = _port_engine(models, **kw)
    for rid, (p, _, _) in enumerate(trace):
        r = ref.add_request(p, 1, prefill_only=True)
        ref.run()
        blocks, _ = ref.take_handoff(r)
        c = ref.cache
        want = [export_pool_block(c.kpool, c.vpool, b) for b in blocks]
        ref.release_handoff(blocks)
        assert len(ingested[rid]) == len(want) == 2
        for g, w in zip(ingested[rid], want):
            assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    assert got == _colocated(models, trace, eos=None, **kw)
    fleet.drain()


def test_fleet_trace_is_one_timeline(models, tmp_path):
    trace = _mixed_trace(np.random.RandomState(2), n=4)
    fleet = _fleet(models, "torch", tracing=True, **PAIR)
    ids = [fleet.add_request(p, max_new_tokens=n, priority=pr)
           for p, n, pr in trace]
    fleet.run()
    path = tmp_path / "fleet.json"
    n = fleet.export_trace(str(path), include_profiler=False)
    events = json.loads(path.read_text())["traceEvents"]
    assert n == len(events)
    procs = {e["pid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    assert sorted(procs.values()) == ["fleet.router", "replica 0 (decode)",
                                      "replica 1 (prefill)"]
    by = {}
    for e in events:
        if e["ph"] != "M" and "req_id" in e.get("args", {}):
            by.setdefault(e["args"]["req_id"], []).append(e)
    assert sorted(by) == sorted(str(i) for i in ids)
    for rid, evs in by.items():
        route = [e for e in evs if e["name"] == "fleet.route"]
        assert len(route) == 1 and procs[route[0]["pid"]] == "fleet.router"
        assert route[0]["args"]["reason"] in ("affinity", "least_loaded")
        assert {"replica", "affinity_tokens"} <= set(route[0]["args"])
        tid = route[0]["args"]["trace_id"]
        assert {e["args"].get("trace_id") for e in evs} == {tid}
        names = {(procs[e["pid"]], e["name"]) for e in evs}
        assert {("fleet.router", "handoff.export"),
                ("fleet.router", "handoff.ingest"),
                ("replica 1 (prefill)", "request.handoff"),
                ("replica 0 (decode)", "request.adopted"),
                ("replica 0 (decode)", "request.finish")} <= names
    with pytest.raises(RuntimeError, match="tracing is off"):
        _fleet(models, "torch", num_replicas=1).export_trace(
            str(tmp_path / "x.json"))
