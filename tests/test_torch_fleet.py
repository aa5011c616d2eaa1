"""The port's serving fleet (`paddle_tpu_torch.inference.ServingFleet`)
against the JAX package's, mixed replicas.

JAX's own sizes (tests/test_serving_fleet.py: vocab 61, hidden 32, 2 layers,
2 heads, seq 64) and seeded numpy traces; the port's weights come from the
JAX model through the weight bridge, its replicas run f32 on the CPU and
JAX's with the dense backend. A 1-replica fleet is bit for bit a bare port
engine; N in {2, 3} replicas serve JAX's fleet's tokens request for request,
with JAX's routing decisions (affinity, hysteresis spill, adapter-salted
chains), shed set, metrics snapshot (family by family, but the trace-count
families of JAX's compiled steps) and seeded `best_of_n` candidates. The
elastic registry is the port's copy of JAX's; async-core replicas serve
JAX's async fleet's tokens and the port's serial fleet's; a traced fleet
folds its replicas' host-gap and trace series; replicas want the card
unless given `device="cpu"`; a dropped fleet frees its pools at once.
"""
import gc
import json
import weakref

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.adapters import AdapterRegistry as JRegistry
from paddle_tpu.inference import ServingFleet as JFleet
from paddle_tpu.inference.sampling import SamplingParams as JParams
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu_torch import (GenerationEngine, GPTConfig, GPTForCausalLM,
                              load_paddle_tpu_state)
from paddle_tpu_torch.adapters import AdapterRegistry
from paddle_tpu_torch.distributed.launch.elastic import ElasticMaster
from paddle_tpu_torch.inference import (REPLICA_ROLES, SamplingParams,
                                        ServingFleet, prefix_key)
from paddle_tpu_torch.observability import series_total

VOCAB = 61
# JAX's compiled-step trace counters (Queue C 24): an eager engine has none
TRACE_COUNT_FAMILIES = {"engine_decode_traces", "engine_prefill_traces",
                        "engine_decode_recompiles_total"}
WALL_GAUGES = {"engine_step_device_fraction"}


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    kw = dict(vocab=VOCAB, hidden=32, layers=2, heads=2, seq=64)
    jm = JGPT(JConfig.tiny(**kw))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig.tiny(**kw), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v._array)
                               for k, v in jm.state_dict().items()})
    return jm, tm.eval()


@pytest.fixture(autouse=True)
def no_switches(monkeypatch):
    for var in ("PADDLE_SERVE_TRACING", "PADDLE_SERVE_ASYNC",
                "PADDLE_SPEC_DECODE_K", "PADDLE_SERVE_KV_DTYPE",
                "PADDLE_SERVE_MP", "PADDLE_SERVE_SAMPLING",
                "PADDLE_SERVE_WEIGHT_DTYPE",
                "PADDLE_PAGED_ATTENTION_BACKEND"):
        monkeypatch.delenv(var, raising=False)


def _fleet(models, pkg, **kw):
    jm, tm = models
    kw.setdefault("num_slots", 4)
    kw.setdefault("block_size", 8)
    if pkg == "jax":
        return JFleet(jm, attention_backend="dense", **kw)
    return ServingFleet(tm, device="cpu", **kw)


# copied from tests/test_serving_fleet.py
def _mixed_trace(rng, n=8):
    """(prompt, max_new, priority) mixed-length QoS trace."""
    prios = ("interactive", "standard", "batch")
    return [(rng.randint(0, VOCAB, int(rng.randint(3, 40))),
             int(rng.randint(2, 10)), prios[i % 3])
            for i in range(n)]


def _serve(fleet, trace, eos=5):
    ids = [fleet.add_request(p, max_new_tokens=n, priority=pr,
                             eos_token_id=eos) for p, n, pr in trace]
    out = fleet.run()
    return {i: list(map(int, out[i])) for i in ids}


def _routed(fleet):
    snap = fleet.metrics_snapshot()
    return {(s["labels"]["replica"], s["labels"]["reason"]): s["value"]
            for s in snap["fleet_routed_total"]["series"]}


def _series_of(fam):
    key = "count" if fam["type"] == "histogram" else "value"
    return {json.dumps(s["labels"], sort_keys=True): s[key]
            for s in fam["series"]}


def test_roles_and_prefix_key_are_jax_s():
    from paddle_tpu.inference import REPLICA_ROLES as J_ROLES
    from paddle_tpu.inference import prefix_key as j_prefix_key

    assert REPLICA_ROLES == J_ROLES
    p = np.arange(37, dtype=np.int32) % VOCAB
    for aid in (0, 1, 7):
        assert prefix_key(p, 8, aid) == j_prefix_key(p, 8, aid)


def test_single_replica_fleet_bitwise_a_bare_engine(models):
    """The fleet adds routing, not numerics: the same mixed QoS trace
    through a 1-replica fleet, a bare port engine and JAX's 1-replica
    fleet."""
    trace = _mixed_trace(np.random.RandomState(0), n=8)
    eng = GenerationEngine(models[1], device="cpu", num_slots=4,
                           block_size=8)
    ids = [eng.add_request(p, max_new_tokens=n, priority=pr, eos_token_id=5)
           for p, n, pr in trace]
    out = eng.run()
    bare = {i: list(map(int, out[i])) for i in ids}
    got = _serve(_fleet(models, "torch", num_replicas=1), trace)
    assert got == bare
    assert got == _serve(_fleet(models, "jax", num_replicas=1), trace)


@pytest.mark.parametrize("n_replicas", [2, 3])
def test_n_replica_fleet_serves_jax_s_tokens_and_routes(models, n_replicas):
    trace = _mixed_trace(np.random.RandomState(1), n=10)
    fleets = {pkg: _fleet(models, pkg, num_replicas=n_replicas)
              for pkg in ("jax", "torch")}
    want, got = (_serve(fleets[pkg], trace) for pkg in ("jax", "torch"))
    assert got == want
    assert _routed(fleets["torch"]) == _routed(fleets["jax"])
    active = [r.rid for r in fleets["torch"]._replicas.values()
              if r.engine.tokens_generated > 0]
    assert len(active) > 1, "router sent everything to one replica"


def _affinity_and_spill(fleet, rng):
    """JAX's affinity and hysteresis scenario: a cold pass seeds one
    replica, three warm passes, then (slack 0) two warm adds back to back.
    Returns what each decision saw."""
    tenant = rng.randint(0, VOCAB, 24)          # 3 full blocks
    fleet.add_request(np.concatenate([tenant, rng.randint(0, VOCAB, 3)]),
                      max_new_tokens=3)
    fleet.run()
    owner = [r.rid for r in fleet._replicas.values()
             if r.engine.cache.warm_prefix_tokens(tenant) > 0]
    for _ in range(3):
        fleet.add_request(np.concatenate([tenant,
                                          rng.randint(0, VOCAB, 3)]),
                          max_new_tokens=3)
        fleet.run()
    warm = _routed(fleet)
    hits = [r.engine.prefix_hit_tokens for r in fleet._replicas.values()]
    affinity = series_total(fleet.metrics_snapshot(),
                            "fleet_affinity_hit_tokens_total")
    fleet.affinity_slack = 0
    fleet.add_request(np.concatenate([tenant, [1]]), max_new_tokens=2)
    fleet.add_request(np.concatenate([tenant, [2]]), max_new_tokens=2)
    spill = _routed(fleet)
    out = fleet.run()
    return owner, warm, hits, affinity, spill, sorted(
        (k, list(map(int, v))) for k, v in out.items())


def test_affinity_routes_and_hysteresis_spill_as_jax(models):
    got = _affinity_and_spill(_fleet(models, "torch", num_replicas=2),
                              np.random.RandomState(4))
    want = _affinity_and_spill(_fleet(models, "jax", num_replicas=2),
                               np.random.RandomState(4))
    assert got == want
    owner, warm, hits, affinity, spill, _ = got
    assert len(owner) == 1
    assert warm[(str(owner[0]), "affinity")] == 3 and affinity == 3 * 24
    assert [h > 0 for h in hits] == [r == owner[0] for r in range(2)]
    # slack 0: the first warm add takes affinity, the second spills
    assert spill[(str(owner[0]), "affinity")] == 4
    assert sum(v for (_, why), v in spill.items()
               if why == "least_loaded") == 2


def _registries(cfg, seed=3):
    """Adapters 1 and 2 (qkv, rank 2) in both packages' registries, from
    the same numpy factors (JAX's `_lora_registry`)."""
    rng = np.random.RandomState(seed)
    regs = JRegistry(cfg, max_rank=2), AdapterRegistry(cfg, max_rank=2)
    H, L = cfg.hidden_size, cfg.num_layers
    for aid in (1, 2):
        w = {"qkv": [(rng.randn(2, H).astype(np.float32) * 0.5,
                      rng.randn(3 * H, 2).astype(np.float32) * 0.5)
                     for _ in range(L)]}
        for reg in regs:
            reg.register(aid, w, scaling=0.5)
    return regs


def _salted(fleet):
    reps = list(fleet._replicas.values())
    p = np.arange(16, dtype=np.int32) % VOCAB
    for rep, aid in zip(reps, (1, 2)):        # warm each tenant's chain
        rep.engine.add_request(p, 2, adapter_id=aid)
        rep.engine.run()
    peeks = [reps[0].engine.cache.warm_prefix_tokens(
        p, keys=prefix_key(p, 8, aid)) for aid in (1, 2)]
    routes = [fleet._route(p, aid) for aid in (1, 2, 0)]
    routes = [(r.rid, why, warm) for r, why, warm in routes]
    hits = [r.engine.prefix_hit_tokens for r in reps]
    r1 = fleet.add_request(p, 3, adapter_id=1)
    r2 = fleet.add_request(p, 3, adapter_id=2)
    out = fleet.run()
    return (peeks, routes, [r.engine.prefix_hit_tokens - h
                            for r, h in zip(reps, hits)],
            list(map(int, out[r1])), list(map(int, out[r2])),
            _routed(fleet))


def test_adapter_salted_routes_as_jax(models):
    jreg, treg = _registries(models[1].config)
    kw = dict(num_replicas=2, num_slots=2, prefill_chunk=8)
    got = _salted(_fleet(models, "torch", adapters=treg, **kw))
    want = _salted(_fleet(models, "jax", adapters=jreg, **kw))
    assert got == want
    peeks, routes, hits, out1, out2, _ = got
    assert peeks == [16, 0]
    assert routes[:2] == [(0, "affinity", 16), (1, "affinity", 16)]
    assert routes[2][1:] == ("least_loaded", 0)
    assert hits == [16, 16] and out1 != out2


def test_unknown_adapter_refused_before_router_state(models):
    _, treg = _registries(models[1].config)
    fleet = _fleet(models, "torch", num_replicas=2, num_slots=2,
                   prefill_chunk=8, adapters=treg)
    p = np.arange(9, dtype=np.int32) % VOCAB
    good = fleet.add_request(p, 2, adapter_id=1)
    with pytest.raises(ValueError, match="not registered"):
        fleet.add_request(p, 2, adapter_id=99)
    bare = _fleet(models, "torch", num_replicas=1, num_slots=2,
                  prefill_chunk=8)
    with pytest.raises(ValueError, match="adapters="):
        bare.add_request(p, 2, adapter_id=1)
    assert fleet.num_outstanding == 1           # no phantom request
    assert list(fleet.run()) == [good]
    assert series_total(fleet.metrics_snapshot(), "fleet_routed_total") == 1


def test_shed_at_max_queue_as_jax(models):
    def shed(pkg):
        fleet = _fleet(models, pkg, num_replicas=1, num_slots=2,
                       max_queue=2)
        rng = np.random.RandomState(8)
        ids = [fleet.add_request(rng.randint(0, VOCAB, 8), max_new_tokens=2,
                                 priority="batch") for _ in range(8)]
        out = fleet.run()
        return ([i for i in ids if out[i] is None],
                series_total(fleet.metrics_snapshot(), "fleet_shed_total"))
    got = shed("torch")
    assert got == shed("jax")
    assert got[0] and got[1] == len(got[0])


def test_metrics_snapshot_is_jax_s_family_by_family(models):
    """Two replicas: every family but JAX's trace counters with JAX's type,
    help and labels, counters and state gauges by value, histograms by
    count (seconds) and by bucket (token counts), the replica label on
    every engine family; the fold sums exactly."""
    trace = _mixed_trace(np.random.RandomState(7), n=8)
    fleets = {pkg: _fleet(models, pkg, num_replicas=2)
              for pkg in ("jax", "torch")}
    outs = {pkg: _serve(f, trace, eos=None) for pkg, f in fleets.items()}
    assert outs["torch"] == outs["jax"]
    js, ts = (fleets[p].metrics_snapshot() for p in ("jax", "torch"))
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
        if name.startswith("engine_"):
            assert "replica" in t["labelnames"], name
    per_replica = {str(r.rid): r.engine.tokens_generated
                   for r in fleets["torch"]._replicas.values()}
    fam = ts["engine_tokens_generated_total"]
    assert {s["labels"]["replica"]: s["value"]
            for s in fam["series"]} == per_replica
    new = sum(len(t) for t in outs["torch"].values()) \
        - sum(len(p) for p, _, _ in trace)
    assert sum(per_replica.values()) == new
    assert series_total(ts, "fleet_routed_total") == len(trace)
    fleets["torch"].reset_metrics()
    assert series_total(fleets["torch"].metrics_snapshot(),
                        "engine_tokens_generated_total") == 0


def test_best_of_n_seeded_as_jax(models):
    """The fleet's best_of_n: JAX's candidates, candidates 1..n-1 routed to
    the replica candidate 0 warmed and hitting its whole prompt, the
    None-seed range claimed fleet-side."""
    prompt = np.random.RandomState(5).randint(0, VOCAB, 21)

    def fan(pkg, cls):
        fleet = _fleet(models, pkg, num_replicas=2, sampling=True)
        cands = fleet.best_of_n(prompt, 3, 8, sampling_params=cls(
            temperature=1.0, seed=9))
        hit = series_total(fleet.metrics_snapshot(),
                           "fleet_affinity_hit_tokens_total")
        before = fleet._seed_counter
        more = fleet.best_of_n(prompt, 2, 2,
                               sampling_params=cls(temperature=1.0))
        return ([list(map(int, c)) for c in cands + more], hit,
                fleet._seed_counter - before)
    got = fan("torch", SamplingParams)
    assert got == fan("jax", JParams)
    assert got[1] == 2 * (len(prompt) // 8) * 8 and got[2] == 2
    assert len({tuple(c) for c in got[0][:3]}) > 1


def test_elastic_join_drain_leave(models):
    """Replicas join the copied master with permanent leases under its job
    token, a wrong token is refused, and they leave on remove_replica and
    drain."""
    master = ElasticMaster(token="job-tok")
    try:
        with pytest.raises(RuntimeError, match="unauthorized"):
            _fleet(models, "torch", num_replicas=1, num_slots=2,
                   elastic_endpoint=master.endpoint, elastic_token="wrong")
        fleet = _fleet(models, "torch", num_replicas=2, num_slots=2,
                       elastic_endpoint=master.endpoint,
                       elastic_token="job-tok")
        live = master.live()
        assert sorted(live) == ["fleet-replica-0", "fleet-replica-1"]
        assert live["fleet-replica-0"] == {"role": "mixed", "num_slots": 2,
                                           "mp_degree": 1,
                                           "_external": False}
        rid = fleet.add_replica()
        assert f"fleet-replica-{rid}" in master.live()
        rng = np.random.RandomState(9)
        ids = [fleet.add_request(rng.randint(0, VOCAB, 10),
                                 max_new_tokens=3) for _ in range(4)]
        fleet.remove_replica(rid)
        assert f"fleet-replica-{rid}" not in master.live()
        assert sorted(fleet.run()) == sorted(ids)
        fleet.drain()
        assert master.live() == {}
        with pytest.raises(RuntimeError, match="draining"):
            fleet.add_request([1], max_new_tokens=1)
        with pytest.raises(RuntimeError, match="draining"):
            fleet.add_replica()
    finally:
        master.close()


def test_remove_last_replica_and_bad_roles_refused(models):
    fleet = _fleet(models, "torch", num_replicas=1, num_slots=2)
    (rid,) = list(fleet._replicas)
    with pytest.raises(ValueError, match="last"):
        fleet.remove_replica(rid)
    with pytest.raises(KeyError):
        fleet.remove_replica(rid + 7)
    with pytest.raises(ValueError, match="needs a disaggregated fleet"):
        fleet.add_replica(role="decode")
    with pytest.raises(ValueError, match="role must be one of"):
        fleet.add_replica(role="router")
    with pytest.raises(ValueError, match=">= 1 serving replica"):
        _fleet(models, "torch", num_replicas=0)


def _flight(eng):
    return [{k: v for k, v in e.items() if k != "t_us"}
            for e in eng.dump_flight_recorder()]


@pytest.mark.parametrize("prefill", [1, 0], ids=["disagg", "mixed"])
def test_async_replicas_serve_jax_s_tokens(models, prefill):
    """Async-core replicas against JAX's async-core fleet on the same
    trace, and against the port's serial fleet; a disaggregated pair also
    hands off as JAX's does, and each replica's flight recorder is JAX's."""
    trace = _mixed_trace(np.random.RandomState(3), n=8)
    kw = dict(num_replicas=2 - prefill, num_prefill_replicas=prefill)
    serial = _serve(_fleet(models, "torch", **kw), trace)
    fleets = {pkg: _fleet(models, pkg, async_core=True, **kw)
              for pkg in ("jax", "torch")}
    for fleet in fleets.values():
        assert all(r.engine.async_core for r in fleet._replicas.values())
    want, got = (_serve(fleets[pkg], trace) for pkg in ("jax", "torch"))
    assert got == want
    assert got == serial
    jf, tf = fleets["jax"], fleets["torch"]
    assert _routed(tf) == _routed(jf)
    if prefill:
        js, ts = jf.metrics_snapshot(), tf.metrics_snapshot()
        for name in ("fleet_handoffs_total", "fleet_handoff_blocks_total",
                     "fleet_handoff_stalls_total"):
            assert series_total(ts, name) == series_total(js, name), name
        assert series_total(ts, "fleet_handoffs_total") > 0
        for jr, tr in zip(jf._replicas.values(), tf._replicas.values()):
            assert tr.role == jr.role
            assert _flight(tr.engine) == _flight(jr.engine), tr.role


def test_a_dropped_fleet_is_freed_at_once(models):
    """No reference cycle runs through the fleet, its replicas or their
    engines: the last reference gone, the pools go without a garbage
    collection (a card gets its memory back)."""
    fleet = _fleet(models, "torch", num_replicas=1, num_prefill_replicas=1,
                   tracing=True, async_core=True)
    _serve(fleet, _mixed_trace(np.random.RandomState(2), n=4))
    pools = [weakref.ref(r.engine.cache.kpool)
             for r in fleet._replicas.values()]
    gone = [weakref.ref(fleet)] + pools
    gc.disable()
    try:
        del fleet
        assert [r() for r in gone] == [None] * 3
    finally:
        gc.enable()


def test_traced_fleet_folds_host_gap_and_trace_series(models):
    """Tracing on: each replica's host-gap buckets appear in the fold
    verbatim under its replica label, the trace counters sum, a second
    stamp of a labelled snapshot raises, and a warm route's span carries
    its affinity arguments."""
    from paddle_tpu_torch.observability import (label_snapshot,
                                                merge_snapshots)

    fleet = _fleet(models, "torch", num_replicas=2, num_slots=2,
                   tracing=True)
    hot = np.random.RandomState(1).randint(0, VOCAB, 16).astype(np.int32)
    _serve(fleet, _mixed_trace(np.random.RandomState(9), n=4) + [
        (hot, 4, "standard")], eos=None)
    fleet.add_request(hot.copy(), 4)           # the warm chain wins
    fleet.run()
    routes = [e for e in fleet.tracer.snapshot()
              if e["name"] == "fleet.route"]
    assert len(routes) == 6
    assert routes[-1]["args"]["reason"] == "affinity"
    assert routes[-1]["args"]["affinity_tokens"] == 16
    snaps = [rep.engine.metrics.snapshot()
             for rep in fleet._replicas.values()]
    merged = fleet.metrics_snapshot()
    hg = merged["engine_step_host_gap_seconds"]
    assert "replica" in hg["labelnames"]
    for rid, snap in zip(fleet._replicas, snaps):
        for s in snap["engine_step_host_gap_seconds"]["series"]:
            match = [m for m in hg["series"]
                     if m["labels"] == {**s["labels"], "replica": str(rid)}]
            assert len(match) == 1
            assert (match[0]["counts"], match[0]["sum"], match[0]["count"]) \
                == (s["counts"], s["sum"], s["count"])
    spans = series_total(merged, "engine_trace_spans_total")
    assert spans > 0 and spans == sum(
        series_total(s, "engine_trace_spans_total") for s in snaps)
    with pytest.raises(ValueError):
        label_snapshot(label_snapshot(snaps[0], replica="0"), replica="1")
    assert series_total(merge_snapshots(snaps),
                        "engine_trace_spans_total") == spans


def test_replicas_default_to_the_card(models, monkeypatch):
    """`engine_options` reach every replica, `device=` with them: without
    it a replica wants the card and raises on a host without one."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingFleet(models[1], num_replicas=1, num_slots=2, block_size=8)
    fleet = _fleet(models, "torch", num_replicas=1, num_prefill_replicas=1,
                   num_slots=2, kv_dtype="int8")
    for rep in fleet._replicas.values():
        assert rep.engine.device.type == "cpu"
        assert rep.engine.kv_dtype == "int8" and rep.engine.num_slots == 2
