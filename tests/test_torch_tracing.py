"""The port's engine telemetry, tracing and flight recorder against the
JAX engine's.

The tracing primitives (`PhaseTimer`, `TraceRecorder`, `FlightRecorder`,
`merge_trace_events`) behave as JAX's classes: exclusive phase accounting,
thread-confined clocks, the ring bound and its drop count. Over one trace
the port's engine and JAX's dense engine (the same weights through the
bridge) give equal metric snapshots — every family, help string, label,
counter value, state gauge and histogram count, save JAX's three
trace-count families, which an eager engine does not register, and the
wall-time values — and equal flight-recorder sequences (every field but
`t_us`). Tracing on is token-identical to tracing off; the switch wins as
in JAX; request spans share one trace id; `export_trace` merges the
profiler's stream; the drain audit carries the flight recorder.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.observability.tracing as jtr
from paddle_tpu.inference import GenerationEngine as JEngine
from paddle_tpu.inference.sampling import SamplingParams as JParams
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
import paddle_tpu_torch.observability.tracing as ttr
from paddle_tpu_torch import (GenerationEngine, GPTConfig, GPTForCausalLM,
                              load_paddle_tpu_state)
from paddle_tpu_torch.inference import SamplingParams
from paddle_tpu_torch.observability import STEP_PHASES, series_total
from paddle_tpu_torch.profiler.profiler import _recorder

VOCAB = 64
# JAX's compiled-step trace counters: an eager engine has no retrace
TRACE_COUNT_FAMILIES = {"engine_decode_traces", "engine_prefill_traces",
                        "engine_decode_recompiles_total"}
# gauges whose value is a wall-time ratio
WALL_GAUGES = {"engine_step_device_fraction"}


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
    for var in ("PADDLE_SERVE_TRACING", "PADDLE_SERVE_ASYNC",
                "PADDLE_SPEC_DECODE_K", "PADDLE_SERVE_KV_DTYPE",
                "PADDLE_SERVE_MP", "PADDLE_SERVE_SAMPLING",
                "PADDLE_SERVE_WEIGHT_DTYPE",
                "PADDLE_PAGED_ATTENTION_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _trace(seed=11):
    """Mixed lengths, motif-tiled prompts (the n-gram drafter hits) and a
    shared prefix served twice (prefix hits, a full hit, COW)."""
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


def _serve(eng, reqs, params=None):
    """Half the trace, two steps, the rest, run; then the whole trace
    again on the warm cache. `params(i)` is request i's sampling."""
    def add(i, p, n):
        kw = {} if params is None else {"sampling_params": params(i)}
        return eng.add_request(p, n, **kw)

    half = len(reqs) // 2
    ids = [add(i, p, n) for i, (p, n) in enumerate(reqs[:half])]
    eng.step()
    eng.step()
    ids += [add(half + i, p, n) for i, (p, n) in enumerate(reqs[half:])]
    out = eng.run()
    ids2 = [add(i, p, n) for i, (p, n) in enumerate(reqs)]
    out2 = eng.run()
    return [None if out[i] is None else list(map(int, out[i]))
            for i in ids] + [None if out2[i] is None
                             else list(map(int, out2[i])) for i in ids2]


def _series_of(fam):
    key = "count" if fam["type"] == "histogram" else "value"
    return {json.dumps(s["labels"], sort_keys=True): s[key]
            for s in fam["series"]}


def assert_snapshots_equal(js, ts):
    """Every family but JAX's trace counters: type, help and labels equal;
    counters and state gauges by value; histograms by count (and bucket
    counts where they count tokens, not seconds); wall-time gauges by
    presence."""
    assert set(ts) == set(js) - TRACE_COUNT_FAMILIES
    for name in sorted(ts):
        j, t = js[name], ts[name]
        for k in ("type", "help", "labelnames"):
            assert t[k] == j[k], (name, k)
        if name in WALL_GAUGES:
            assert len(t["series"]) == len(j["series"]), name
            continue
        assert _series_of(t) == _series_of(j), name
        if t["type"] == "histogram" and not name.endswith("_seconds"):
            assert [s["counts"] for s in t["series"]] == \
                [s["counts"] for s in j["series"]], name


def _flight(eng):
    return [{k: v for k, v in e.items() if k != "t_us"}
            for e in eng.dump_flight_recorder()]


CASES = {
    "chunked_k0": dict(),
    "chunked_k4": dict(spec_decode_k=4),
    "bucketed_kv8_k4": dict(prefill_chunk=None, prefill_buckets=(16, 64),
                            kv_dtype="int8", spec_decode_k=4),
    "sampled_k4": dict(sampling=True, spec_decode_k=4),
    "traced_k4_shed": dict(tracing=True, spec_decode_k=4, max_queue=3),
    "mp2": dict(mp_degree=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_snapshot_and_flight_recorder_are_jax_s(models, no_switches,
                                                       case):
    jm, tm = models
    kw = dict(num_slots=3, block_size=4, num_blocks=24, **CASES[case])
    if "prefill_chunk" not in kw:
        kw["prefill_chunk"] = 8
    params = None
    if kw.get("sampling"):
        def params(i, pkg=None):
            return None if i % 3 else (pkg or SamplingParams)(
                temperature=0.8, top_k=20, top_p=0.9, seed=100 + i)
    jeng = JEngine(jm, attention_backend="dense", **kw)
    teng = GenerationEngine(tm, device="cpu", **kw)
    want = _serve(jeng, _trace(), params and (lambda i: params(i, JParams)))
    got = _serve(teng, _trace(), params)
    assert got == want
    js, ts = jeng.metrics_snapshot(), teng.metrics_snapshot()
    assert_snapshots_equal(js, ts)
    assert _flight(teng) == _flight(jeng)
    # the plain counters agree with the series
    assert series_total(ts, "engine_tokens_generated_total") == \
        teng.tokens_generated
    assert series_total(ts, "engine_admissions_total") == teng.admissions
    stalls = {s["labels"]["path"]: s["value"]
              for s in ts["engine_block_stalls_total"]["series"]}
    assert all(stalls.get(p, 0) == n for p, n in teng.stalls.items())
    assert series_total(ts, "engine_cow_copies_total") == teng.cow_copies
    assert series_total(ts, "engine_shed_total") == teng.shed
    assert series_total(ts, "engine_prefix_cache_hit_tokens_total") == \
        teng.prefix_hit_tokens
    if case == "mp2":
        assert _series_of(ts["engine_mesh_info"]) == {
            json.dumps({"devices": "2", "mp_degree": "2"}): 1.0}
        assert list(_series_of(ts["engine_pool_used_blocks"])) == [
            json.dumps({"shard": "0"})]


@pytest.mark.parametrize("K", [0, 4])
def test_tracing_on_is_token_identical_to_off(models, no_switches, K):
    _, tm = models
    outs, engs = [], []
    for on in (False, True):
        eng = GenerationEngine(tm, device="cpu", num_slots=2, block_size=4,
                               prefill_chunk=8, spec_decode_k=K, tracing=on)
        outs.append(_serve(eng, _trace(3)))
        engs.append(eng)
    off, on = engs
    assert outs[0] == outs[1]
    assert off.tracer is None and on.tracer is not None
    assert "engine_trace_spans_total" not in off.metrics_snapshot()
    assert series_total(on.metrics_snapshot(),
                        "engine_trace_spans_total") == \
        on.tracer.total_recorded


@pytest.mark.parametrize("value,on", [("1", True), ("0", False)])
def test_tracing_switch_wins_as_in_jax(models, no_switches, value, on):
    jm, tm = models
    no_switches.setenv("PADDLE_SERVE_TRACING", value)
    kw = dict(num_slots=2, block_size=4, tracing=not on)
    teng = GenerationEngine(tm, device="cpu", **kw)
    jeng = JEngine(jm, attention_backend="dense", **kw)
    assert teng.tracing is jeng.tracing is on
    assert (teng.tracer is None) is (jeng.tracer is None) is (not on)


@pytest.mark.parametrize("K", [0, 4])
def test_host_gap_phases_and_device_fraction(models, no_switches, K):
    _, tm = models
    eng = GenerationEngine(tm, device="cpu", num_slots=2, block_size=4,
                           prefill_chunk=8, spec_decode_k=K)
    _serve(eng, _trace(1))
    snap = eng.metrics_snapshot()
    hg = snap["engine_step_host_gap_seconds"]["series"]
    phases = {s["labels"]["phase"] for s in hg}
    expect = {"schedule", "dispatch", "device_wait", "finish"}
    if K:
        expect |= {"draft_propose", "accept_walk"}
    assert expect <= phases <= set(STEP_PHASES)
    assert all(s["count"] > 0 and s["sum"] >= 0 for s in hg)
    frac = snap["engine_step_device_fraction"]["series"][0]["value"]
    assert 0.0 <= frac <= 1.0


def test_request_spans_share_one_trace_id_and_export_merges_profiler(
        models, no_switches, tmp_path):
    _, tm = models
    eng = GenerationEngine(tm, device="cpu", num_slots=2, block_size=4,
                           prefill_chunk=8, tracing=True)
    reqs = _trace(5)[:3]
    _recorder.enabled = True
    try:
        ids = [eng.add_request(p, n, req_id=i, trace_id=f"t{i}" if i == 0
                               else None) for i, (p, n) in enumerate(reqs)]
        eng.run()
    finally:
        _recorder.enabled = False
    events = eng.tracer.snapshot()
    by_req = {}
    for e in events:
        a = e.get("args") or {}
        if "req_id" in a:
            by_req.setdefault(a["req_id"], set()).add(a.get("trace_id"))
    assert set(by_req) == {str(i) for i in ids}
    assert all(len(t) == 1 for t in by_req.values())
    assert by_req["0"] == {"t0"}
    assert len({t for ts in by_req.values() for t in ts}) == 3
    names = {e["name"] for e in events}
    assert {"request.queued", "request.admitted", "request.first_token",
            "request.finish", "prefill.chunk", "decode.step"} <= names
    assert any(e.get("cat") == "phase" for e in events)
    path = tmp_path / "timeline.json"
    n = eng.export_trace(str(path))
    _recorder.drain()
    evs = json.loads(path.read_text())["traceEvents"]
    assert len(evs) == n
    assert {e["args"]["name"] for e in evs if e["ph"] == "M"} == \
        {"engine", "profiler"}
    with pytest.raises(RuntimeError, match="tracing is off"):
        GenerationEngine(tm, device="cpu", num_slots=2, block_size=4) \
            .export_trace(str(tmp_path / "nope.json"))


def test_drain_audit_attaches_the_flight_recorder(models, no_switches):
    _, tm = models
    eng = GenerationEngine(tm, device="cpu", num_slots=2, block_size=4)
    _serve(eng, _trace(2)[:2])
    eng.cache.allocate(1)              # a block dropped on the floor
    with pytest.raises(RuntimeError) as ei:
        eng.drain()
    msg = str(ei.value)
    assert "leak check failed" in msg and "flight recorder" in msg
    assert "finish" in msg


def test_trace_ring_bound_holds_under_load(models, no_switches):
    _, tm = models
    eng = GenerationEngine(tm, device="cpu", num_slots=2, block_size=4,
                           tracing=True, trace_capacity=16)
    _serve(eng, _trace(6)[:4])
    assert len(eng.tracer.snapshot()) == 16 and eng.tracer.dropped > 0
    assert series_total(eng.metrics_snapshot(),
                        "engine_trace_dropped_total") == eng.tracer.dropped


# -- the primitives against JAX's -------------------------------------------

@pytest.mark.parametrize("mod", [jtr, ttr], ids=["jax", "port"])
def test_phase_timer_exclusive_and_thread_confined(mod):
    """Nested phases pause the enclosing one; a helper thread's phase
    lands on its own clock only (the async core's drafter)."""
    pt = mod.PhaseTimer()
    t0 = time.perf_counter()
    with pt.phase("outer"):
        time.sleep(0.005)
        with pt.phase("inner"):
            time.sleep(0.01)
    wall = time.perf_counter() - t0
    tot = pt.totals()
    assert set(tot) == {"outer", "inner"} and tot["inner"] >= 0.01
    assert tot["outer"] + tot["inner"] <= wall + 0.005
    assert pt.reset() == tot and pt.totals() == {}
    helper = {}

    def work():
        with pt.phase("draft_propose"):
            time.sleep(0.01)
        helper.update(pt.totals())

    with pt.phase("dispatch"):
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()
    assert set(pt.totals()) == {"dispatch"}
    assert set(helper) == {"draft_propose"}


def test_ring_flight_and_merge_are_jax_s():
    """The same records into both packages' recorders: the retained
    events (pids and clocks aside), drops, the flight dump and its
    formatted tail, and merged timelines agree."""
    rings = [m.TraceRecorder(capacity=4) for m in (jtr, ttr)]
    flights = [m.FlightRecorder(capacity=3) for m in (jtr, ttr)]
    for ring, fl in zip(rings, flights):
        for i in range(10):
            ring.add_span(f"s{i}", i, i + 2, trace_id="t", args={"k": i})
            ring.add_instant(f"i{i}", ts_us=i, trace_id="t")
        for i in range(5):
            fl.record("ev", req_id=i, k=i * 10)
    snaps = [r.snapshot() for r in rings]
    assert snaps[0] == snaps[1]
    assert [r.dropped for r in rings] == [16, 16]
    dumps = [[{k: v for k, v in e.items() if k != "t_us"} for e in f.dump()]
             for f in flights]
    assert dumps[0] == dumps[1]

    def tail(f):
        return [line.split("] ", 1)[-1] for line in f.format().splitlines()]
    assert tail(flights[0]) == tail(flights[1])
    groups = [("alpha", snaps[1][:2]), ("beta", snaps[1][2:])]
    assert ttr.merge_trace_events(groups) == jtr.merge_trace_events(groups)
    for m in (jtr, ttr):
        with pytest.raises(ValueError):
            m.TraceRecorder(capacity=0)
    tid = ttr.new_trace_id()
    assert tid.startswith(f"{os.getpid():x}-") and ttr.new_trace_id() != tid
    assert ttr.STEP_PHASES == jtr.STEP_PHASES
