"""Replica-parallel serving tier: counterpart of paddle_tpu/inference/fleet.py,
a prefix-affinity router over N `GenerationEngine` replicas, with optional
disaggregated prefill/decode.

- **Routing** (`add_request`): admission control (the fleet's `max_queue`
  shed), QoS passthrough (the priority rides to the replica's own class
  queues), and prefix-cache affinity: the router hashes the prompt's
  full-block chain with the `prefix_key` digests the replicas' caches key
  their blocks with (a router key IS a cache key) and steers the request to
  the replica whose cache holds the deepest warm chain
  (`warm_prefix_tokens`, a read-only peek). Affinity yields to load with
  hysteresis: the warm replica wins unless its backlog exceeds the
  least-loaded replica's by more than `affinity_slack` requests. Cold
  requests go least-loaded (lowest id on a tie), which keeps a 1-replica
  fleet bit for bit a bare engine. Under adapters the chain is salted with
  the request's adapter id, as the caches salt it.
- **Disaggregated prefill/decode** (`num_prefill_replicas > 0`): prefill
  replicas run each prompt to its first token (`prefill_only` requests),
  then the router copies the prompt's KV out of the source pool block by
  block (`ops.paged_attention.export_pool_block_shards`, the int8 scale
  rows riding along), releases the source blocks, and, once a decode
  replica has a free lane and the blocks, writes the rows into blocks of
  that replica's pool (`ingest_pool_block_shards`) and seats the lane
  mid-stream (`GenerationEngine.adopt_request`). The payloads are bit
  copies, so disaggregated output is the colocated engine's token for
  token. JAX compiles the export and ingest once per replica with traced
  block ids and donated pools; here they are eager copies on the current
  stream, ordered after the step that wrote the rows, with no host wait.
  Under a mesh each shard's rows move to the same shard on the destination.
- **Operations**: `metrics_snapshot()` folds every replica's registry
  replica-labelled through `label_snapshot` and `merge_snapshots` (the
  host-gap histograms and trace counters included); with tracing on, the
  router records its own spans (`fleet.route`, `handoff.export`,
  `handoff.ingest`) and `export_trace` writes one timeline with a track a
  replica; replicas join the elastic registry
  (`distributed.launch.elastic`) with permanent leases and leave it on
  `remove_replica` or `drain`.

The fleet is one process, host-driven like the engine: `step()` runs every
replica's scheduler iteration in turn (with `async_core=True` replicas a
step leaves its decode step in flight, and the handoff work overlaps it),
`run()` drives to completion. All replicas may share one card.
"""
from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np

from ..observability.metrics import (LATENCY_BUCKETS, MetricsRegistry,
                                     label_snapshot, merge_snapshots)
from ..observability.tracing import (TraceRecorder, export_timeline,
                                     new_trace_id, now_us,
                                     profiler_host_events)
from ..ops.paged_attention import (export_pool_block_shards,
                                   ingest_pool_block_shards)
from .engine import (PRIORITY_CLASSES, GenerationEngine, _best_of_n_fanout,
                     _best_of_n_intake, prefix_key)

__all__ = ["ServingFleet", "REPLICA_ROLES"]

#: A replica serves end to end ("mixed", the default fleet) or one side of
#: the disaggregated split ("prefill" runs prompts to their first token and
#: hands the KV blocks off; "decode" adopts handed-off lanes and decodes).
REPLICA_ROLES = ("mixed", "prefill", "decode")

_ELASTIC_PREFIX = "fleet-replica-"


class _Replica:
    """One engine replica plus its router-side identity: a stable id
    (never reused: removal must not re-key another replica's metrics or
    elastic membership), its role and its retirement flag (a retiring
    replica finishes its work but takes no new routes)."""

    def __init__(self, rid, engine, role):
        self.rid = rid
        self.engine = engine
        self.role = role
        self.retired = False

    @property
    def load(self):
        """Router load signal: requests accepted and not finished (queued
        + seated)."""
        return self.engine.num_pending + self.engine.num_active


class ServingFleet:
    """N GenerationEngine replicas behind one prefix-affinity router.

        fleet = ServingFleet(model, num_replicas=2, num_slots=8)
        fleet.add_request([1, 2, 3], max_new_tokens=32)
        results = fleet.run()            # {req_id: prompt + tokens}

    Disaggregated prefill/decode:

        fleet = ServingFleet(model, num_replicas=1,
                             num_prefill_replicas=1, num_slots=8)

    `engine_options` go to every replica's GenerationEngine (num_slots,
    block_size, spec_decode_k, kv_dtype, mp_degree, async_core, ... and the
    port's `device=`: the card by default, the CPU only for
    `device="cpu"`); replicas are homogeneous. Each replica keeps its own
    metrics registry; `metrics_snapshot()` folds them replica-labelled.
    `elastic_endpoint` (+ `elastic_token`, by default
    `$PADDLE_ELASTIC_TOKEN`) registers every replica on the elastic
    registry; `remove_replica` and `drain` leave it."""

    def __init__(self, model, num_replicas=1, num_prefill_replicas=0,
                 max_queue=None, affinity_slack=None,
                 elastic_endpoint=None, elastic_token=None,
                 registry=None, **engine_options):
        if num_replicas < 1:
            raise ValueError(
                f"need >= 1 serving replica, got {num_replicas}")
        if num_prefill_replicas < 0:
            raise ValueError(
                f"num_prefill_replicas must be >= 0, got "
                f"{num_prefill_replicas}")
        self.model = model
        self._engine_options = dict(engine_options)
        self.disaggregated = num_prefill_replicas > 0
        self.max_queue = None if max_queue is None else int(max_queue)
        self._elastic = None
        if elastic_endpoint is not None:
            from ..distributed.launch.elastic import ElasticClient

            self._elastic = ElasticClient(elastic_endpoint,
                                          token=elastic_token)
        self._replicas = OrderedDict()     # rid -> _Replica, id order
        self._next_rid = 0
        self._requests = {}                # req_id -> routing record
        self._pending_handoffs = []        # exported, awaiting a lane
        self._handoff_seq = 0
        self._done = {}
        self._auto_id = 0
        # None seeds resolve HERE, before a handoff splits the request
        # across replicas: the prefill replica's first draw and the decode
        # replica's adopted key row come from the same seed
        self._seed_counter = 0
        self._draining = False
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        self._init_metrics()
        decode_role = "decode" if self.disaggregated else "mixed"
        for _ in range(num_replicas):
            self.add_replica(role=decode_role)
        for _ in range(num_prefill_replicas):
            self.add_replica(role="prefill")
        # the affinity hysteresis: a warm replica wins until its backlog
        # exceeds the least-loaded one's by more than this many requests
        # (one full batch by default)
        if affinity_slack is None:
            affinity_slack = self._any_engine().num_slots
        self.affinity_slack = int(affinity_slack)
        # tracing follows the replicas' knob; the router keeps its own
        # span ring, a track of its own in the exported timeline
        self.tracing = bool(self._any_engine().tracing)
        self.tracer = TraceRecorder(process_name="fleet.router") \
            if self.tracing else None

    # -- replica management ------------------------------------------------
    def _any_engine(self):
        return next(iter(self._replicas.values())).engine

    def _build_engine(self):
        return GenerationEngine(self.model, **self._engine_options)

    def add_replica(self, role=None):
        """Bring one replica into the fleet: build its engine and register
        it on the elastic registry (a permanent lease; the registry refuses
        a wrong job token). Returns the replica id."""
        if self._draining:
            raise RuntimeError("fleet is draining — no new replicas")
        if role is None:
            role = "decode" if self.disaggregated else "mixed"
        if role not in REPLICA_ROLES:
            raise ValueError(
                f"role must be one of {REPLICA_ROLES}, got {role!r}")
        if self.disaggregated and role == "mixed":
            raise ValueError(
                "a disaggregated fleet has prefill and decode "
                "replicas — 'mixed' would let long-prompt prefill "
                "steal decode-step FLOPs again")
        if not self.disaggregated and role != "mixed":
            raise ValueError(
                f"role {role!r} needs a disaggregated fleet "
                "(num_prefill_replicas > 0)")
        rid = self._next_rid
        self._next_rid += 1
        rep = _Replica(rid, self._build_engine(), role)
        self._replicas[rid] = rep
        if self._elastic is not None:
            self._elastic.register(
                f"{_ELASTIC_PREFIX}{rid}",
                info={"role": role,
                      "num_slots": rep.engine.num_slots,
                      "mp_degree": rep.engine.mp_degree},
                ttl=None)
        self._update_replica_gauges()
        return rid

    def remove_replica(self, rid):
        """Graceful elastic leave: retire the replica from routing, drive
        the fleet until its work (and any handoff it sourced) finished,
        drain it (admissions closed, pool leak check), drop its elastic
        membership. Finished results stay collectable through `run()`."""
        rep = self._replicas.get(rid)
        if rep is None:
            raise KeyError(f"no replica {rid}")
        peers = [r for r in self._routable(rep.role) if r.rid != rid]
        if not peers:
            raise ValueError(
                f"replica {rid} is the last {rep.role!r}-capable "
                "replica — removing it would strand the queue (drain "
                "the fleet instead)")
        rep.retired = True
        while rep.engine.num_pending or rep.engine.num_active \
                or rep.engine._handoffs:
            if self.step() == 0:
                raise RuntimeError(
                    f"cannot drain replica {rid}: its lanes are "
                    "stalled and no fleet progress is possible")
        rep.engine.drain()                 # at once: audits the pool
        if self._elastic is not None:
            self._elastic.leave(f"{_ELASTIC_PREFIX}{rid}")
        del self._replicas[rid]
        self._update_replica_gauges()

    def _routable(self, role):
        """Live, non-retiring replicas of `role`, in id order."""
        return [r for r in self._replicas.values()
                if r.role == role and not r.retired]

    @property
    def num_replicas(self):
        return len(self._replicas)

    # -- metrics -----------------------------------------------------------
    def _init_metrics(self):
        """JAX's fleet families, under its names, help strings (verbatim)
        and labels."""
        m = self.metrics
        self._m_replicas = m.gauge(
            "fleet_replicas",
            "Live serving replicas, by role.", labelnames=("role",))
        self._m_routed = m.counter(
            "fleet_routed_total",
            "Requests routed, by replica id and why it won (affinity "
            "= deepest warm prefix chain within the hysteresis band; "
            "least_loaded = cold or affinity yielded to load).",
            labelnames=("replica", "reason"))
        self._m_affinity_tokens = m.counter(
            "fleet_affinity_hit_tokens_total",
            "Prompt tokens the router placed onto a replica already "
            "owning their warm prefix blocks (the tokens the affinity "
            "decision saved from recomputation).")
        self._m_shed = m.counter(
            "fleet_shed_total",
            "Requests shed at fleet admission (max_queue exceeded), "
            "by priority class.", labelnames=("priority",))
        self._m_handoffs = m.counter(
            "fleet_handoffs_total",
            "Prefill->decode handoffs completed (prompt KV exported "
            "from a prefill replica and adopted by a decode "
            "replica).")
        self._m_handoff_blocks = m.counter(
            "fleet_handoff_blocks_total",
            "KV pool blocks moved across replicas by the "
            "disaggregated handoff path.")
        self._m_handoff_stalls = m.counter(
            "fleet_handoff_stalls_total",
            "Iterations a finished prefill sat exported-but-unplaced "
            "for want of a decode lane or pool blocks.")
        self._m_pending_handoffs = m.gauge(
            "fleet_pending_handoffs",
            "Finished prefills currently awaiting a decode replica.")
        self._m_handoff_wait = m.histogram(
            "fleet_handoff_wait_seconds",
            "Prefill-finish to decode-adoption latency (the "
            "disaggregation seam's contribution to TBT).",
            buckets=LATENCY_BUCKETS)

    def _update_replica_gauges(self):
        counts = {role: 0 for role in REPLICA_ROLES}
        for rep in self._replicas.values():
            counts[rep.role] += 1
        for role in REPLICA_ROLES:
            self._m_replicas.labels(role=role).set(counts[role])

    def reset_metrics(self):
        """Zero the fleet registry and every replica's, in place."""
        self.metrics.reset()
        for rep in self._replicas.values():
            rep.engine.metrics.reset()

    def metrics_snapshot(self):
        """The router's own series plus every replica engine's registry,
        each stamped `replica=<id>` and folded through `merge_snapshots`:
        counters and buckets sum exactly, the replica label keeps the
        per-replica series side by side (host-gap histograms and trace
        counters included). Host-side, no collectives."""
        snaps = [self.metrics.snapshot()]
        for rid in sorted(self._replicas):
            snaps.append(label_snapshot(
                self._replicas[rid].engine.metrics.snapshot(),
                replica=str(rid)))
        return merge_snapshots(snaps)

    def export_trace(self, path, include_profiler=True):
        """One Perfetto timeline for the whole fleet: the router's routing
        and handoff spans plus every replica engine's span ring, a track
        group each (one process, one monotonic clock: a disaggregated
        request's prefill, handoff and decode spans line up under its
        `trace_id`). Returns the event count written."""
        if self.tracer is None:
            raise RuntimeError(
                "tracing is off — build the fleet with tracing=True "
                "(or PADDLE_SERVE_TRACING=1) to record spans")
        groups = [("fleet.router", self.tracer.snapshot())]
        for rid in sorted(self._replicas):
            rep = self._replicas[rid]
            if rep.engine.tracer is not None:
                groups.append((f"replica {rid} ({rep.role})",
                               rep.engine.tracer.snapshot()))
        if include_profiler:
            ev = profiler_host_events()
            if ev:
                groups.append(("profiler", ev))
        return export_timeline(path, groups)

    # -- routing -----------------------------------------------------------
    def _route(self, prompt, adapter_id=0):
        """Pick the intake replica: the deepest warm `prefix_key` chain
        (salted with `adapter_id`) wins while its backlog stays within
        `affinity_slack` of the least-loaded intake replica's; otherwise
        the least loaded (lowest id on a tie). Returns (replica, reason,
        warm_tokens)."""
        intake = self._routable(
            "prefill" if self.disaggregated else "mixed")
        if not intake:
            raise RuntimeError("fleet has no intake replica")
        loads = {r.rid: r.load for r in intake}
        min_load = min(loads.values())
        best, best_hit, keys = None, 0, None
        for r in intake:
            if not r.engine.enable_prefix_cache:
                continue
            if keys is None:
                # hash the prompt once; the replicas share block_size
                keys = prefix_key(prompt, r.engine.block_size, adapter_id)
            hit = r.engine.cache.warm_prefix_tokens(prompt, keys=keys)
            if hit > best_hit:
                best, best_hit = r, hit
        if best is not None \
                and loads[best.rid] <= min_load + self.affinity_slack:
            return best, "affinity", best_hit
        cold = min(intake, key=lambda r: (loads[r.rid], r.rid))
        return cold, "least_loaded", 0

    def add_request(self, prompt, max_new_tokens, eos_token_id=None,
                    req_id=None, priority="standard", adapter_id=0,
                    sampling_params=None):
        """Admit one request into the fleet: `GenerationEngine.add_request`'s
        contract (priority classes, auto ids, validation, `adapter_id`),
        plus fleet admission control: with `max_queue` set and that many
        requests queued fleet-wide (handoffs awaiting a lane included), the
        request is shed (result None). Routing is prefix affinity first,
        least loaded otherwise; in a disaggregated fleet the request lands
        on a prefill replica as `prefill_only` and the rest of its budget
        rides the handoff. A None seed in `sampling_params` is resolved
        here, from the fleet's counter, so the prefill replica's first draw
        and the decode replica's key row share one seed."""
        if self._draining:
            raise RuntimeError(
                "fleet is draining — admissions are closed")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if priority not in PRIORITY_CLASSES:
            raise ValueError(f"priority must be one of "
                             f"{PRIORITY_CLASSES}, got {priority!r}")
        # validate before any router state changes: an unknown adapter
        # must not leave a phantom request that deadlocks run()
        adapter_id = self._any_engine()._check_adapter(adapter_id)
        sampling_params = self._any_engine()._check_sampling(
            sampling_params)
        if sampling_params is not None and sampling_params.seed is None:
            sampling_params = sampling_params.with_seed(
                self._seed_counter)
            self._seed_counter += 1
        total = prompt.size + int(max_new_tokens)
        limit = self._any_engine().max_model_len
        if total > limit:
            raise ValueError(
                f"prompt({prompt.size}) + max_new({max_new_tokens}) ="
                f" {total} exceeds max_model_len={limit}")
        if req_id is None:
            while self._auto_id in self._requests \
                    or self._auto_id in self._done:
                self._auto_id += 1
            req_id = self._auto_id
            self._auto_id += 1
        elif req_id in self._requests or req_id in self._done:
            raise ValueError(f"req_id {req_id!r} is already in flight "
                             "or awaiting collection")
        if self.max_queue is not None and self.max_queue <= sum(
                r.engine.num_pending
                for r in self._replicas.values()) \
                + len(self._pending_handoffs):
            self._m_shed.labels(priority=priority).inc()
            self._done[req_id] = None
            return req_id
        trace_id = new_trace_id() if self.tracing else None
        t_route = now_us()
        rep, reason, warm = self._route(prompt, adapter_id)
        if self.tracer is not None:
            self.tracer.add_span(
                "fleet.route", t_route, now_us(), trace_id=trace_id,
                cat="router",
                args={"req_id": str(req_id), "replica": rep.rid,
                      "reason": reason, "affinity_tokens": warm})
        self._m_routed.labels(replica=str(rep.rid), reason=reason).inc()
        if warm:
            self._m_affinity_tokens.inc(warm)
        # the EFFECTIVE eos (the engine's default as fallback), so the
        # handoff's finished-on-arrival check agrees with the replica's
        if eos_token_id is None:
            eos_token_id = rep.engine.eos_token_id
        info = {"prompt": prompt, "max_new": int(max_new_tokens),
                "eos": eos_token_id, "priority": priority,
                "arrived": time.perf_counter(), "replica": rep.rid,
                "adapter_id": int(adapter_id),
                "sampling": sampling_params, "trace_id": trace_id,
                "phase": "prefill" if self.disaggregated else "serve"}
        self._requests[req_id] = info
        rep.engine.add_request(
            prompt, 1 if self.disaggregated else max_new_tokens,
            eos_token_id=eos_token_id, req_id=req_id, priority=priority,
            prefill_only=self.disaggregated, adapter_id=adapter_id,
            sampling_params=sampling_params, trace_id=trace_id)
        return req_id

    def best_of_n(self, prompt, n, max_new_tokens, sampling_params=None,
                  eos_token_id=None, priority="standard", adapter_id=0):
        """The fleet's `GenerationEngine.best_of_n`: candidate 0 is served
        first (its prefill warms one replica's prefix chain), then
        candidates 1..n-1 (seeds `base+1..base+n-1`) route by affinity to
        that replica and seat the prompt's blocks read-only. Drives
        `run()`; other work is served along the way and stays collectable.
        Returns the n candidate token lists in seed order."""
        params, base, self._seed_counter = _best_of_n_intake(
            self._any_engine(), sampling_params, n, self._seed_counter)
        out, stash = _best_of_n_fanout(
            lambda p: self.add_request(
                prompt, max_new_tokens, eos_token_id=eos_token_id,
                priority=priority, adapter_id=adapter_id,
                sampling_params=p),
            self.run, params, n, base)
        self._done.update(stash)       # bystander finishes collectable
        return out

    # -- disaggregated handoff ---------------------------------------------
    def _export_handoff(self, rep, req_id, toks):
        """A prefill replica finished `req_id`: claim its parked blocks,
        copy every block's rows (and int8 scale rows) out of the source
        pools, release the source blocks (prefix-cached ones stay warm for
        the router) and queue the payload for a decode lane. A request
        whose first token is EOS, or whose budget is 1, is complete: its
        blocks are released and nothing is exported."""
        info = self._requests[req_id]
        eng = rep.engine
        blocks, _hit = eng.take_handoff(req_id)
        first = int(toks[-1])
        done_eos = info["eos"] is not None and first == info["eos"]
        if done_eos or info["max_new"] <= 1:
            eng.release_handoff(blocks)
            self._finalize(req_id, toks)
            return
        c = eng.cache
        t_exp = now_us()
        # copies, on the current stream after the step that wrote them:
        # the blocks go back to the source allocator right after
        payload = [export_pool_block_shards(c.kpools, c.vpools, b,
                                            c.scale_shards)
                   for b in blocks]
        eng.release_handoff(blocks)
        if self.tracer is not None:
            self.tracer.add_span(
                "handoff.export", t_exp, now_us(),
                trace_id=info.get("trace_id"), cat="handoff",
                args={"req_id": str(req_id), "from_replica": rep.rid,
                      "blocks": len(blocks)})
        info["phase"] = "handoff"
        self._pending_handoffs.append(
            {"req_id": req_id, "payload": payload, "first": first,
             "seq": self._handoff_seq,
             "parked_at": time.perf_counter()})
        self._handoff_seq += 1
        self._m_pending_handoffs.set(len(self._pending_handoffs))

    def _place_handoff(self, h):
        """Land one exported prefill on a decode replica: the least-loaded
        replica with a free lane, an adapter page and the blocks (falling
        through to a busier one on pool pressure), each payload block
        written into its pools, then the lane adopted mid-stream. False
        when no replica can take it this iteration."""
        info = self._requests[h["req_id"]]
        targets = sorted((r for r in self._routable("decode")
                          if r.engine.free_lanes > 0
                          and r.engine.adapter_page_available(
                              info.get("adapter_id", 0))),
                         key=lambda r: (r.load, r.rid))
        need = len(h["payload"])
        rep = blocks = None
        for cand in targets:
            blocks = cand.engine.cache.allocate(need)
            if blocks is not None:
                rep = cand
                break
        if rep is None:
            return False
        eng = rep.engine
        c = eng.cache
        t_ing = now_us()
        for parts, dst in zip(h["payload"], blocks):
            ingest_pool_block_shards(c.kpools, c.vpools, parts[0],
                                     parts[1], dst, c.scale_shards,
                                     parts[2] if len(parts) > 2 else None)
        req_id = h["req_id"]
        eng.adopt_request(info["prompt"], h["first"], blocks,
                          info["max_new"], eos_token_id=info["eos"],
                          req_id=req_id, priority=info["priority"],
                          arrived_at=info["arrived"],
                          adapter_id=info.get("adapter_id", 0),
                          sampling_params=info.get("sampling"),
                          trace_id=info.get("trace_id"))
        if self.tracer is not None:
            self.tracer.add_span(
                "handoff.ingest", t_ing, now_us(),
                trace_id=info.get("trace_id"), cat="handoff",
                args={"req_id": str(req_id), "to_replica": rep.rid,
                      "blocks": need})
        info["phase"] = "decode"
        info["replica"] = rep.rid
        self._m_handoffs.inc()
        self._m_handoff_blocks.inc(need)
        self._m_handoff_wait.observe(time.perf_counter() - h["parked_at"])
        return True

    def _flush_handoffs(self):
        """Place as many queued handoffs as decode capacity allows, best
        priority class first (FIFO within a class). Strict priority: a
        blocked class blocks every class below it."""
        if not self._pending_handoffs:
            return 0
        self._pending_handoffs.sort(key=lambda h: (
            PRIORITY_CLASSES.index(
                self._requests[h["req_id"]]["priority"]), h["seq"]))
        placed, remaining = 0, []
        blocked = set()
        for h in self._pending_handoffs:
            cls = self._requests[h["req_id"]]["priority"]
            if cls in blocked or any(
                    PRIORITY_CLASSES.index(b) <
                    PRIORITY_CLASSES.index(cls) for b in blocked):
                remaining.append(h)
                continue
            if self._place_handoff(h):
                placed += 1
            else:
                self._m_handoff_stalls.inc()
                blocked.add(cls)
                remaining.append(h)
        self._pending_handoffs = remaining
        self._m_pending_handoffs.set(len(self._pending_handoffs))
        return placed

    # -- drive -------------------------------------------------------------
    def _finalize(self, req_id, toks):
        self._done[req_id] = toks
        self._requests.pop(req_id, None)

    def _collect(self, rep, results):
        for req_id in sorted(results, key=str):
            toks = results[req_id]
            info = self._requests.get(req_id)
            if info is None or toks is None:
                # shed by the replica's own max_queue: final, no decode leg
                self._finalize(req_id, toks)
                continue
            if info["phase"] == "prefill":
                self._export_handoff(rep, req_id, toks)
            else:
                self._finalize(req_id, toks)

    def step(self):
        """One fleet iteration: place queued handoffs, then one scheduler
        iteration on every replica with work, collecting finishes as they
        land, then place again into the lanes those steps vacated and
        prefetch the adapter pages of handoffs still queued. With
        async-core replicas each `step()` returns with its decode step in
        flight, so the placements run while the device works. Returns the
        placements, engine progress and finishes (0: the fleet cannot
        move)."""
        progressed = self._flush_handoffs()
        for rid in list(self._replicas):
            rep = self._replicas[rid]
            eng = rep.engine
            if eng.num_pending or eng.num_active:
                progressed += eng.step()
            results = eng.pop_results()
            if results:
                progressed += len(results)
                self._collect(rep, results)
        if self._pending_handoffs:
            progressed += self._flush_handoffs()
            self._prestage_handoffs()
        return progressed

    def _prestage_handoffs(self):
        """For each queued handoff under an adapter, warm that adapter's
        page on the least-loaded decode replica that can take it
        (`PagedAdapterPool.prefetch`: no reference taken, no placement
        decided), so the adoption finds the page resident."""
        staged = set()
        for h in self._pending_handoffs:
            info = self._requests.get(h["req_id"])
            if info is None:
                continue
            aid = int(info.get("adapter_id", 0) or 0)
            if not aid or aid in staged:
                continue
            targets = sorted(self._routable("decode"),
                             key=lambda r: (r.load, r.rid))
            for rep in targets:
                pool = rep.engine.adapter_pool
                if pool is None or not pool.registry.has(aid):
                    continue
                if pool.page_of(aid) is not None or pool.prefetch(
                        aid, non_blocking=rep.engine._staged) is not None:
                    staged.add(aid)
                    rep.engine.flight.record(
                        "adapter_prefetch", h["req_id"], adapter=aid,
                        page=pool.page_of(aid))
                    break

    @property
    def num_outstanding(self):
        """Requests admitted and not finished (any phase)."""
        return len(self._requests)

    def run(self):
        """Drive until every admitted request finished; returns (and
        clears) {req_id: prompt + generated tokens; None if shed}."""
        while self._requests:
            if self.step() == 0:
                pend = len(self._pending_handoffs)
                frees = {r.rid: r.engine.cache.num_free
                         for r in self._replicas.values()}
                raise RuntimeError(
                    "serving fleet deadlocked: "
                    f"{len(self._requests)} request(s) in flight, "
                    f"{pend} handoff(s) unplaceable, free blocks per "
                    f"replica {frees} — grow num_blocks/num_slots or "
                    "add replicas")
        out, self._done = self._done, {}
        return out

    def drain(self):
        """Fleet-wide graceful shutdown: close admissions, finish every
        request (handoffs included), drain each replica (its admission
        close and pool leak check) and drop every elastic membership.
        Returns the final results."""
        self._draining = True
        out = self.run()
        for rid in list(self._replicas):
            rep = self._replicas.pop(rid)
            rep.retired = True
            rep.engine.drain()
            if self._elastic is not None:
                self._elastic.leave(f"{_ELASTIC_PREFIX}{rid}")
        self._update_replica_gauges()      # fleet_replicas -> 0
        return out
