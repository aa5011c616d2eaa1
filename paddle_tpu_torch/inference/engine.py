"""Continuous-batching generation engine over a paged KV cache: counterpart
of paddle_tpu/inference/engine.py (greedy or sampled lanes, fp or int8
pools, int8 weights, speculative decoding, chunked or bucketed prefill,
multi-tenant LoRA adapters, tensor-parallel serving over a mesh, serial
core).

- `PagedKVCache`: pools `[layers, num_blocks, block_size, heads, head_dim]`
  on the device plus a host-side allocator with per-block refcounts and a
  chain-hash prefix cache over FULL prompt blocks. Block 0 is the null
  block. Cached blocks whose refcount drops to zero park in an LRU pool and
  are evicted only when an allocation needs them.
- a slot scheduler: `num_slots` decode lanes. Queued requests are admitted
  into free lanes (priority classes first, FIFO within a class), seating the
  longest cached prefix read-only; each `step()` runs at most ONE chunk of
  chunked prefill and then one batched decode step over every decode-phase
  lane. A lane that cannot get a block stalls and retries next step.
- copy-on-write: a decode write about to land in a shared or cached block
  first copies it to a private block.
- speculative decoding (`spec_decode_k=K > 0`): the decode step becomes a
  verify step over a `[slots, K+1]` window, the feed token plus up to K
  tokens a drafter proposed (`NgramDrafter` by default); the longest
  draft prefix equal to the target's argmax is accepted, plus the
  target's own next token. Rejected rows need no cleanup: the lane does
  not advance past them and attention is bounded by position.
- int8 KV (`kv_dtype="int8"`): int8 pools plus a `[layers, num_blocks, 2]`
  f32 per-block K/V scale array, quantized on every write.
- sampling (`sampling=True`): `add_request(sampling_params=SamplingParams(
  temperature, top_k, top_p, seed))` per request; each step passes per-row
  temperature, top-k, top-p and key rows, greedy lanes take the argmax (bit
  for bit a `sampling=False` engine's), sampled lanes one draw under
  `fold_in(fold_in(key_row(seed), position), salt)`: jax's keys and bits,
  so a stream is the JAX engine's token for token (`ops.sampling`). Under
  K > 0 the verify step runs the rejection-sampling acceptance
  (`verify_window`); `best_of_n` fans one prompt into n seeded candidates
  that share its cached prompt blocks.
- int8 weights (`weight_dtype="int8"`): an int8 snapshot of the qkv, out,
  fc1 and fc2 weights, per-output-channel scales
  (`quantization.quantize_absmax`), which the paged forwards read through
  `ops.int8_linear`; embeddings, norms, biases and the tied head stay fp.
  `refresh_weights()` re-quantizes after a weight edit.
- the attention backend (`attention_backend`, or the environment's
  `PADDLE_PAGED_ATTENTION_BACKEND`, which wins): `auto`/`dense`/`pallas`
  resolved once by `ops.paged_attention.resolve_backend`; `pallas` runs
  the paged kernels, `dense` their plain versions on every device.
- the deploy switches, resolved as the JAX engine resolves them: the
  environment wins over the argument and an empty value means unset.
  `PADDLE_SPEC_DECODE_K` over `spec_decode_k`, `PADDLE_SERVE_KV_DTYPE`
  over `kv_dtype` and `PADDLE_SERVE_WEIGHT_DTYPE` over `weight_dtype`
  (unset or `int8`), `PADDLE_SERVE_SAMPLING` over `sampling`,
  `PADDLE_SERVE_MP` over `mp_degree` (and it must agree with `mesh`),
  `PADDLE_SERVE_TRACING` over `tracing` and `PADDLE_SERVE_ASYNC` over
  `async_core`.
- prefill, resolved as in JAX: chunked (`prefill_chunk="auto"`, the
  default, being `min(128, max_model_len)`, or an int), or bucketed
  (`prefill_chunk=None`, or `prefill_buckets=` with `"auto"`): each
  admission pads its whole prompt to the smallest bucket of the ladder
  (16, 32, ... up to `max_model_len` by default) that holds it, runs it
  through `GPTModel.forward_prefill` (causal attention: the causal kernel
  on the card) and writes its KV into freshly allocated blocks with
  `ops.paged_attention.paged_prefill_write`. The prefix cache follows the
  strategy (`enable_prefix_cache=None`); it needs chunked prefill.
- multi-tenant adapters (`adapters=`, an `adapters.AdapterRegistry` or a
  prebuilt `adapters.PagedAdapterPool`): `add_request(adapter_id=)`
  serves each request under its tenant's LoRA adapter. The pool pages
  adapters as the cache pages blocks (`1 + num_slots` pages by default,
  `adapter_pool_pages=`); a lane takes its page after its KV blocks and
  stalls (`stalls["adapter"]`) when none is free; every step passes the
  per-slot page row (idle lanes the null page 0) to the model, whose four
  projections a layer add their delta through `ops.lora.batched_lora`.
  The prefix cache's chains are salted with the adapter id, and `drain()`
  audits the pool's pages too.
- tensor-parallel serving (`mp_degree=N`, `mesh=distributed.serving_mesh(
  N, ...)` or `PADDLE_SERVE_MP=N`): one scheduler, as in JAX (its steps are
  one SPMD program over an `('mp',)` mesh; here the engine runs each
  shard's work in turn). The pools are head-sharded (`[layers, blocks,
  block_size, heads / N, head_dim]` a shard on its device, the block
  tables, allocator, prefix cache, COW and QoS unchanged), the weights a
  column-parallel snapshot (`_tp_plan`, `_build_tp_state`; int8 codes and
  scales quantized on the original layout, then regrouped and sharded),
  the adapter pool's B pages sharded alike; int8 KV grids stay global
  (each write folds the shards' absmax). The greedy argmax, the acceptance
  walk and the draws run once, on the gathered logits on the first
  shard's device. A mesh may name one device N times (a virtual mesh: the
  same per-shard work on one card, or on the CPU), as JAX's CPU tests run
  its meshes on faked host devices. `refresh_weights()` re-shards after a
  weight edit.

- observability, as in JAX: a metrics registry (`registry=`, by default
  one per engine; `engine.metrics`, `metrics_snapshot()`,
  `render_prometheus()`) with JAX's families, names, help strings and
  labels (TTFT/TPOT histograms by priority and by adapter, queue, slot
  and pool gauges with the high-water mark, the mesh and shard-labelled
  pool gauges, finish, stall, COW, shed and prefix-hit counters, the
  spec, sampling and adapter families), except the trace-count families
  of JAX's compiled steps (`engine_decode_traces`, `engine_prefill_traces`,
  `engine_decode_recompiles_total`): an eager engine does not retrace.
  The always-on step-phase clock (`engine_step_host_gap_seconds{phase}`,
  `engine_step_device_fraction`) and flight recorder (`flight_capacity=`,
  `dump_flight_recorder()`; `drain()`'s leak audit attaches it), and with
  `tracing=True` request-scoped spans (`add_request(trace_id=)`,
  `trace_capacity=`, `export_trace(path)`). All of it is host-side: a
  traced engine launches the same kernels, the same number of times.
- the async core (`async_core=True`): a one-step dispatch-ahead pipeline.
  `step()` completes the decode or verify step the previous call left in
  flight (the pipeline's only wait: a CUDA event recorded after the
  step's token readback into pinned host memory), proposes the next
  drafts on a helper thread while it admits and runs a prefill chunk,
  dispatches the next step without waiting on it (its host rows staged in
  pinned memory, copied without a wait), then prefetches the queue head's
  adapter page. Tokens are the serial core's; the serial core runs its
  schedule, dispatch and complete stages in one call.

The pools (and scales) are updated IN PLACE by every step (PyTorch is
eager: there is no compiled step, no donation, no trace count). Greedy
output matches `GPTForCausalLM.generate(use_cache=True)` per request, with
or without speculation; int8 pools hold to the JAX int8 engine instead.

Left for later slices (ROADMAP Queue A): the fleet (its handoff and
`adopt_request`, the fleet's `best_of_n`).
"""
from __future__ import annotations

import hashlib
import math
import os
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from ..adapters import AdapterRegistry, PagedAdapterPool
from ..device import resolve_device
from ..distributed import serving_mesh
from ..models.gpt import TensorParallel
from ..observability.metrics import LATENCY_BUCKETS, MetricsRegistry
from ..observability.tracing import (FlightRecorder, PhaseTimer,
                                     TraceRecorder, export_timeline,
                                     new_trace_id, now_us,
                                     profiler_host_events)
from ..ops.lora import LoraState
from ..ops.paged_attention import (KV_QUANT_EPS, copy_pool_block,
                                   paged_prefill_write,
                                   paged_prefill_write_shards,
                                   resolve_backend)
from ..ops.sampling import sample_token, verify_window
from ..profiler import RecordEvent
from ..quantization import quantize_absmax
from .sampling import SamplingParams, key_row
from .speculative import NgramDrafter, draft_thread_state, draft_window

__all__ = ["PagedKVCache", "GenerationEngine", "Request", "PRIORITY_CLASSES",
           "prefix_key", "iter_prefix_key"]


# copied verbatim from paddle_tpu/inference/engine.py so that the port's
# cache keys equal the JAX package's (and its fleet router's)
def iter_prefix_key(tokens, block_size, adapter_id=0):
    """Lazy form of `prefix_key`: yields the chain digests one full
    block at a time, so walkers that break at the first cache miss
    (`match_prefix`, `warm_prefix_tokens` on a cold cache) hash only
    as deep as they look."""
    tokens = np.asarray(tokens, np.int32)
    bs = int(block_size)
    # adapter-id SALT (multi-tenant LoRA serving): a tenant adapter
    # changes the qkv projections, so the KV a prompt's prefill writes
    # depends on the adapter — the same base prompt under two adapters
    # must hash to DISJOINT chains or a cache hit would seat the wrong
    # tenant's KV. Adapter 0 (the null/base adapter) salts with the
    # empty seed, so base-model prefix reuse keys exactly as before.
    h = b"" if not adapter_id else hashlib.blake2b(
        b"adapter:%d" % int(adapter_id), digest_size=16).digest()
    for i in range(len(tokens) // bs):
        h = hashlib.blake2b(
            h + tokens[i * bs:(i + 1) * bs].tobytes(),
            digest_size=16).digest()
        yield h


# copied from paddle_tpu/inference/engine.py: best-of-n's intake checks
# and its fan-out loop
def _best_of_n_intake(eng, sampling_params, n, counter):
    """Shared best-of-n validation + None-seed RANGE claim. `eng` is the
    serving engine, `counter` the caller's deterministic seed counter.
    Returns (params, base, advanced counter); advancing by one instead of
    n would hand seeds base+1..base+n-1 out again to later None-seed
    requests, replaying candidates."""
    if n < 1:
        raise ValueError(f"need n >= 1 candidates, got {n}")
    if not eng.sampling:
        raise ValueError(
            "best_of_n needs sampling=True engines "
            "(GenerationEngine(sampling=True); fleets pass it in "
            "engine_options) — n greedy lanes would be n identical "
            "candidates")
    if not eng.enable_prefix_cache:
        raise ValueError(
            "best_of_n needs the prefix cache (chunked prefill) — "
            "without it every candidate re-prefills the prompt")
    params = eng._check_sampling(
        sampling_params if sampling_params is not None
        else SamplingParams())
    if params.greedy:
        raise ValueError(
            "best_of_n needs temperature > 0 — greedy candidates "
            "would all be the same continuation")
    if params.seed is None:
        return params, counter, counter + int(n)
    return params, params.seed, counter


def _best_of_n_fanout(add, run, params, n, base):
    """The best-of-n candidate loop: candidate 0 is served to completion
    FIRST — its prefill writes and registers the prompt's full blocks
    once — then candidates 1..n-1 admit against the warm prefix, seeds
    `base..base+n-1`. Returns (candidates in seed order, bystander
    finishes the two run() calls collected along the way)."""
    ids = [add(params.with_seed(base))]
    stash = run()
    for i in range(1, int(n)):
        ids.append(add(params.with_seed(base + i)))
    stash.update(run())
    out = [stash.pop(i) for i in ids]
    if any(c is None for c in out):
        # a candidate was load-shed at admission (max_queue pressure
        # with no lower-priority victim) — a silent None in the
        # returned list would violate the n-candidates contract
        raise RuntimeError(
            f"best_of_n: {sum(c is None for c in out)} of {n} "
            "candidates were shed at admission under max_queue "
            "pressure — serve best_of_n with queue headroom for n "
            "candidates (or raise max_queue)")
    return out, stash


def prefix_key(tokens, block_size, adapter_id=0):
    """Chain digests over the FULL blocks of `tokens`: digest `i` is
    blake2b(digest[i-1] ‖ block_i_tokens), seeded with an adapter-id
    salt (0 — the null/base adapter — seeds empty), so a digest names
    a block's content AND its whole prefix AND the adapter whose
    projections wrote its KV — position/prefix/tenant-safe by
    construction. Returns a tuple of 16-byte digests, one per full
    block (the ragged tail contributes nothing).

    This is the ONE hashing truth shared by the prefix cache
    (`PagedKVCache.match_prefix`/`register_prefix` key their block map
    with these digests) and the fleet router
    (`inference.fleet.ServingFleet` steers a request to the replica
    whose cache owns the deepest digest of its prompt) — factored out
    so the two can never drift: a router key IS a cache key."""
    return tuple(iter_prefix_key(tokens, block_size, adapter_id))


class PagedKVCache:
    """Global paged KV pools on the device + host-side block allocator,
    refcounts and hash-based prefix cache.

    `allocate` hands blocks out at refcount 1, `share` seats a live block
    in another owner's table (+1), `free` decrements and recycles at zero.
    `register_prefix` publishes a prompt's FULL blocks under their chain
    hashes once their KV is written; `match_prefix` walks the chain and
    takes a reference on every hit. A cached block at refcount zero parks
    in an LRU pool, still matchable, until `allocate` evicts it.

    `kv_dtype="int8"`: the pools hold int8 codes and `scales`
    `[layers, num_blocks, 2]` f32 holds each block's K (column 0) and V
    (column 1) grid, filled with `KV_QUANT_EPS`; `dtype` stays the model
    dtype the attention output casts back to. Without it `scales` is
    None.

    `mesh` (a `distributed.ServingMesh`) head-shards the pools: `kpools`
    and `vpools` hold one `shard_spec()` plane a shard, on its device, and
    `scale_shards` the int8 scales a shard (replicated: one tensor a
    distinct device, shards on one device share it; `scales` is the first
    shard's). `pool_spec()` stays the logical whole; the block tables,
    allocator, refcounts and prefix cache do not depend on the mesh.
    Without a mesh `kpools == [kpool]`."""

    def __init__(self, num_layers, num_blocks, block_size, num_heads,
                 head_dim, dtype=torch.float32, device=None, kv_dtype=None,
                 mesh=None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null "
                             "block)")
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None (fp pools) or 'int8', got "
                f"{kv_dtype!r}")
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.kv_dtype = kv_dtype
        self.dtype = dtype
        # tensor-parallel serving: the pools sharded on the HEADS axis (one
        # plane pair a shard); the block tables stay host-side and
        # replicated, so the allocator, prefix cache and COW below do not
        # depend on the mesh
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            devices = (self.device,)
        else:
            mp = mesh.shape["mp"]
            if self.num_heads % mp:
                raise ValueError(
                    f"num_heads={num_heads} not divisible by mp "
                    f"degree {mp} — cannot head-shard the KV pools")
            devices = mesh.devices
            self.device = devices[0]
        shape, dt = self.shard_spec()
        self.kpools = [torch.zeros(shape, dtype=dt, device=d)
                       for d in devices]
        self.vpools = [torch.zeros(shape, dtype=dt, device=d)
                       for d in devices]
        self.scale_shards = self.scales = None
        if kv_dtype == "int8":
            shape, dt = self.scale_spec()
            # the per-(layer, block) grids are GLOBAL across the
            # head-sharded pools (every write folds the shards' absmax), so
            # the array replicates
            reps = {d: torch.full(shape, KV_QUANT_EPS, dtype=dt, device=d)
                    for d in dict.fromkeys(devices)}
            self.scale_shards = [reps[d] for d in devices]
            self.scales = self.scale_shards[0]
        # LIFO free list: recently-freed blocks are reused first
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._ref = [0] * self.num_blocks
        self._ref[0] = 1               # null block: permanently held
        self._block_of = {}            # chain hash -> cached block id
        self._hash_of = {}             # cached block id -> chain hash
        self._evictable = OrderedDict()   # refcount-0 cached, oldest first
        # optional observer called with each block id the allocator
        # reclaims from the prefix cache (the engine's flight recorder)
        self.on_evict = None

    def pool_spec(self):
        """The ONE source of truth for a pool plane's logical `([layers,
        blocks, block_size, heads, head_dim], dtype)`: int8 under
        `kv_dtype="int8"`. The shards' planes derive from it
        (`shard_spec`)."""
        dt = torch.int8 if self.kv_dtype == "int8" else self.dtype
        return ((self.num_layers, self.num_blocks, self.block_size,
                 self.num_heads, self.head_dim), dt)

    @property
    def mp_degree(self):
        return 1 if self.mesh is None else self.mesh.shape["mp"]

    def shard_spec(self):
        """One shard's plane: `pool_spec()` with `heads / mp` heads."""
        (L, nb, bs, heads, d), dt = self.pool_spec()
        return (L, nb, bs, heads // self.mp_degree, d), dt

    def _one(self, planes, name):
        if len(planes) != 1:
            raise AttributeError(
                f"the pools are head-sharded over {len(planes)} shards: "
                f"read {name}s (a plane a shard)")
        return planes[0]

    @property
    def kpool(self):
        """The K pool (one device; under a mesh see `kpools`)."""
        return self._one(self.kpools, "kpool")

    @property
    def vpool(self):
        """The V pool (one device; under a mesh see `vpools`)."""
        return self._one(self.vpools, "vpool")

    def scale_spec(self):
        """`([layers, blocks, 2], float32)` for int8 pools, else None."""
        if self.kv_dtype != "int8":
            return None
        return ((self.num_layers, self.num_blocks, 2), torch.float32)

    def pool_nbytes(self):
        """Bytes of the paged KV state: both pools of every shard plus the
        scales (each replica the mesh holds)."""
        held = {id(t): t for t in self.kpools + self.vpools
                + (self.scale_shards or [])}
        return sum(t.numel() * t.element_size() for t in held.values())

    @property
    def num_free(self):
        """Blocks allocatable now: truly free + evictable cached."""
        return len(self._free) + len(self._evictable)

    @property
    def num_cached_blocks(self):
        """Blocks the prefix cache can serve hits from right now."""
        return len(self._block_of)

    def refcount(self, block):
        return self._ref[block]

    def allocate(self, n):
        """n blocks at refcount 1, or None (the caller stalls and retries)
        if the pool cannot serve them even after evicting every
        refcount-zero cached block, oldest first."""
        if n > self.num_free:
            return None
        take = min(n, len(self._free))
        got = self._free[-take:] if take else []
        del self._free[-take:]
        while len(got) < n:            # reclaim cold cache blocks
            block, h = self._evictable.popitem(last=False)
            del self._block_of[h]
            del self._hash_of[block]
            got.append(block)
            if self.on_evict is not None:
                self.on_evict(block)   # a warm prefix block lost its content
        for b in got:
            self._ref[b] = 1
        if got and self.scales is not None:
            # a recycled block's grid belongs to its previous tenant: reset
            # it to the floor (in every replica) so the new owner's first
            # write sets a fresh grid. One fill a block: an index list
            # would be uploaded with a host sync
            for sc in {id(t): t for t in self.scale_shards}.values():
                for b in got:
                    sc[:, b].fill_(KV_QUANT_EPS)
        return got

    def copy_block(self, src, dst):
        """Copy block `src` to `dst` on every shard, the int8 grid rows
        riding along (the engine's copy-on-write)."""
        for i, (kp, vp) in enumerate(zip(self.kpools, self.vpools)):
            copy_pool_block(kp, vp, src, dst,
                            None if self.scales is None
                            else self.scale_shards[i])

    def free(self, blocks):
        """Drop one reference per block, deepest first; recycle at zero
        (cached blocks park in the LRU instead). Raises on the null block
        and on a double free."""
        for b in reversed(list(blocks)):
            b = int(b)
            if b == 0:
                raise ValueError("refusing to free the null block 0")
            if self._ref[b] <= 0:
                raise RuntimeError(
                    f"double free of pool block {b} (refcount already "
                    "0) — a live block would have been handed out twice")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                h = self._hash_of.get(b)
                if h is None:
                    self._free.append(b)
                else:
                    self._evictable[b] = h   # newest LRU entry

    def share(self, blocks):
        """Take an extra reference on live blocks."""
        for b in blocks:
            if self._ref[b] <= 0:
                raise RuntimeError(f"cannot share dead block {b}")
            self._ref[b] += 1

    def needs_cow(self, block):
        """True when a write into `block` would change what another owner
        (a slot or the prefix cache) reads."""
        return self._ref[block] > 1 or block in self._hash_of

    def match_prefix(self, tokens, adapter_id=0):
        """Longest cached block-aligned prefix of `tokens` under
        `adapter_id`'s salted chain: takes a reference on every hit
        (reviving evictable ones) and returns (blocks, hit_tokens). A
        different adapter's chain never aliases it."""
        blocks = []
        for h in iter_prefix_key(tokens, self.block_size, adapter_id):
            b = self._block_of.get(h)
            if b is None:
                break
            if self._ref[b] == 0:
                del self._evictable[b]     # revive: live again
            self._ref[b] += 1
            blocks.append(b)
        return blocks, len(blocks) * self.block_size

    def warm_prefix_tokens(self, tokens, keys=None, adapter_id=0):
        """Prompt tokens a `match_prefix` would serve right now: a
        read-only peek (no references taken). `keys` lets a caller that
        probes several caches hash the prompt once (`prefix_key`)."""
        hit = 0
        for h in (keys if keys is not None
                  else iter_prefix_key(tokens, self.block_size, adapter_id)):
            if h not in self._block_of:
                break
            hit += self.block_size
        return hit

    def register_prefix(self, tokens, blocks, adapter_id=0):
        """Publish a fully prefilled prompt's FULL blocks under
        `adapter_id`'s salted chain (first writer wins). Returns the number
        of blocks newly cached."""
        added = 0
        keys = iter_prefix_key(tokens, self.block_size, adapter_id)
        for h, blk in zip(keys, blocks):
            b = int(blk)
            if h in self._block_of or b in self._hash_of:
                continue
            self._block_of[h] = b
            self._hash_of[b] = h
            added += 1
        return added

    def leak_check(self):
        """Audit of a quiesced pool: every non-null block must be free or a
        refcount-zero cached block. Returns the leaked block ids."""
        free = set(self._free)
        return [b for b in range(1, self.num_blocks)
                if not (self._ref[b] == 0
                        and (b in free or b in self._evictable))]


# copied from paddle_tpu/inference/engine.py (GenerationEngine's static
# methods), so that a switch parses, and fails, as it does there
def _resolve_dtype_knob(env_name, requested):
    """Resolve a quantization knob: env override wins, '' means
    unset, only None/'int8' are valid (the fp path is the absence
    of the knob, not a named dtype)."""
    env = os.environ.get(env_name)
    if env not in (None, ""):
        requested = env
    if requested in (None, ""):
        return None
    if requested != "int8":
        raise ValueError(
            f"{env_name}/ctor value must be unset or 'int8', got "
            f"{requested!r}")
    return "int8"


def _resolve_bool_knob(env_name, requested):
    """Resolve a boolean serving knob: env override wins, ''
    means unset, None defaults to off."""
    env = os.environ.get(env_name)
    if env not in (None, ""):
        low = env.lower()
        if low in ("1", "true", "on", "yes"):
            return True
        if low in ("0", "false", "off", "no"):
            return False
        raise ValueError(
            f"{env_name}={env!r} is not a boolean (use 0/1)")
    return bool(requested) if requested is not None else False


# admission QoS classes, best-served first
PRIORITY_CLASSES = ("interactive", "standard", "batch")


@dataclass(eq=False)
class Request:
    """One generation request (prompt in, greedy continuation out).
    Identity equality: equal prompts are still distinct requests."""

    req_id: object
    prompt: np.ndarray                 # int32 [plen]
    max_new_tokens: int
    eos_token_id: int = None
    arrived_at: float = None           # perf_counter at add_request
    priority: str = "standard"         # one of PRIORITY_CLASSES
    # the request's SamplingParams (seed resolved at intake), or None for
    # the greedy contract
    sampling: object = None
    adapter_id: int = 0                # tenant adapter (0: the base model)
    # the id every span of this request carries (None on an engine with
    # tracing off)
    trace_id: object = None


@dataclass(eq=False)
class _Slot:
    """A live decode lane: the request plus its paged-cache footprint."""

    req: Request
    blocks: list                       # owned/shared pool block ids
    generated: list = field(default_factory=list)
    last_token_at: float = None        # perf_counter of the newest token
    prefill_pos: int = 0               # next prompt position to prefill
    hit_tokens: int = 0                # prefix-cache tokens never computed
    admit_seq: int = 0                 # admission order tiebreak
    adapter_page: int = 0              # the request's adapter pool page
    # per-slot sampling state (greedy lanes: 0 / 0 / 1.0 / no key row)
    temp: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    key_row: object = None             # [2] int64 tensor of uint32 values

    @property
    def prefilling(self):
        return self.prefill_pos < len(self.req.prompt)

    @property
    def feed_pos(self):
        """Absolute position of the token about to be fed: the newest
        generated token, or the last prompt token after a full-prefix hit
        (its logits give the first generated token)."""
        return len(self.req.prompt) + len(self.generated) - 1

    @property
    def feed_token(self):
        return self.generated[-1] if self.generated \
            else int(self.req.prompt[-1])


@dataclass(eq=False)
class _InFlight:
    """One dispatched decode or verify step whose tokens the host has not
    read yet. The async core leaves one across `step()` calls (never
    more); the serial core completes it in the same call."""

    out: tuple                         # the step's token tensors (device)
    runnable: list                     # lane indices dispatched
    slots: list                        # their _Slot objects
    drafts: dict = None                # lane -> draft (verify steps)
    host: tuple = None                 # pinned copies of `out` (async, CUDA)
    event: object = None               # recorded after those copies
    t_dec: float = 0.0                 # perf_counter at dispatch
    t_span: int = 0                    # now_us at dispatch start
    seq: int = 0                       # pipeline sequence number


def _dtype_name(dt):
    """A torch dtype's name as numpy spells it (`float32`, `bfloat16`)."""
    return str(dt).replace("torch.", "")


class GenerationEngine:
    """Iteration-level scheduler over a paged cache.

        engine = GenerationEngine(model, num_slots=8, block_size=16)
        engine.add_request([1, 2, 3], max_new_tokens=32)
        ...                                  # add more any time
        results = engine.run()               # {req_id: full token list}

    `model` is a `GPTForCausalLM`. `device=None` means the CUDA card (and
    raises without one); it must be the model's device. The pools take
    the model's dtype, or int8 with `kv_dtype="int8"`. `spec_decode_k=K`
    turns each decode step into a K-token verify step over drafts from
    `drafter` (an `NgramDrafter` when None); K=0 is plain decoding.
    `PADDLE_SPEC_DECODE_K` and `PADDLE_SERVE_KV_DTYPE` win over those two
    arguments. `weight_dtype="int8"` (or `PADDLE_SERVE_WEIGHT_DTYPE`)
    serves the qkv, out, fc1 and fc2 weights from an int8 snapshot;
    `sampling=True` (or `PADDLE_SERVE_SAMPLING`) takes per-request
    `SamplingParams`. `prefill_chunk` is `"auto"` (`min(128,
    max_model_len)`, or bucketed prefill when `prefill_buckets` is given),
    an int, or None (bucketed prefill over `prefill_buckets`, by default
    16, 32, ... up to `max_model_len`); `enable_prefix_cache=None` turns
    the prefix cache on with chunked prefill and off with bucketed.
    `adapters` (an `AdapterRegistry`, or a `PagedAdapterPool` no other
    engine pages for) turns on multi-tenant LoRA serving over a pool of
    `adapter_pool_pages` pages (`1 + num_slots` by default), in the
    model's dtype.
    `mp_degree=N` (or `mesh=`, a `distributed.serving_mesh(N, ...)`; or
    `PADDLE_SERVE_MP`, which wins) serves tensor-parallel over N shards:
    the default mesh is the host's first N cards (or the CPU N times for
    `device="cpu"`); a virtual mesh on one card is passed as
    `mesh=serving_mesh(N, devices=["cuda"] * N)`. `mp_degree` and `mesh`
    (None at 1) read back what was resolved.
    `attention_backend` (`auto` by default) is resolved once into
    `attention_backend` (`dense` or `pallas`); `auto` is dense at head dims
    and block sizes the kernels do not take. Counters: `tokens_generated`,
    `admissions`, `prefix_hit_tokens`, `cow_copies`, `prefill_chunks`,
    `decode_steps` (verify steps when K > 0), `stalls` by path (`prefill`,
    `decode`, `admit`: a bucketed admission without its blocks, `adapter`:
    an admission without an adapter page, and `spec_degrade`: a lane that
    shed its draft under pool pressure and still ran), `shed`,
    `spec_accepted_tokens`, `spec_rejected_tokens`, `sampled_tokens`
    (tokens of temperature > 0 lanes), `prefill_first_tokens` (first
    tokens a prefill yielded: a final chunk or a bucketed prefill), and
    the adapter pool's `adapter_swapins` and `adapter_evictions`; the
    metrics registry (`registry=`, a fresh `MetricsRegistry` by default)
    holds the same numbers as JAX's series.
    `tracing=True` (or `PADDLE_SERVE_TRACING`) records request-scoped
    spans into a ring of `trace_capacity` events (`export_trace`); the
    flight recorder keeps the last `flight_capacity` lifecycle events.
    `async_core=True` (or `PADDLE_SERVE_ASYNC`) pipelines the decode or
    verify step one call ahead (module docstring).
    """

    def __init__(self, model, num_slots=8, block_size=16, num_blocks=None,
                 max_model_len=None, eos_token_id=None, prefill_chunk="auto",
                 enable_prefix_cache=None, max_queue=None, device=None,
                 spec_decode_k=0, drafter=None, kv_dtype=None,
                 attention_backend=None, prefill_buckets=None,
                 weight_dtype=None, sampling=None, adapters=None,
                 adapter_pool_pages=None, mesh=None, mp_degree=None,
                 registry=None, tracing=None, trace_capacity=4096,
                 flight_capacity=256, async_core=None):
        cfg = model.config
        if model.training and cfg.dropout > 0:
            raise ValueError("GenerationEngine decodes deterministically "
                             "(no dropout) — call model.eval() first")
        self.device = resolve_device(device)
        self._resolve_mesh(mesh, mp_degree, cfg)
        if self.mesh is not None:
            self.device = self.mesh.devices[0]
        wte = model.gpt.wte.weight
        if wte.device.type != self.device.type:
            raise ValueError(f"the model lives on {wte.device}, the engine "
                             f"was asked for {self.device}")
        self.model = model
        self.num_slots = int(num_slots)
        self.block_size = int(block_size)
        self.max_model_len = int(max_model_len or cfg.max_seq_len)
        if self.max_model_len > cfg.max_seq_len:
            raise ValueError(
                f"max_model_len={self.max_model_len} exceeds the "
                f"model's position table ({cfg.max_seq_len})")
        self.max_blocks = math.ceil(self.max_model_len / self.block_size)
        # the paged attention's backend: the argument, overridden by the
        # environment, resolved once, so every step runs the same one
        requested = os.environ.get("PADDLE_PAGED_ATTENTION_BACKEND") \
            or attention_backend or "auto"
        self.attention_backend_requested = requested
        self.attention_backend = resolve_backend(
            requested, head_dim=cfg.hidden_size // cfg.num_heads,
            block_size=self.block_size)
        self.eos_token_id = eos_token_id
        self.max_queue = None if max_queue is None else int(max_queue)
        # prefill strategy, as JAX resolves it: chunked (a fixed chunk a
        # step) or bucketed (the whole prompt, padded to a bucket, at
        # admission); "auto" with buckets means bucketed
        if prefill_chunk == "auto":
            prefill_chunk = None if prefill_buckets is not None \
                else min(128, self.max_model_len)
        elif prefill_chunk is not None and prefill_buckets is not None:
            raise ValueError("prefill_chunk and prefill_buckets are "
                             "mutually exclusive prefill strategies")
        self.prefill_chunk = None if prefill_chunk is None \
            else max(1, min(int(prefill_chunk), self.max_model_len))
        self.chunked_prefill = self.prefill_chunk is not None
        # the prefix cache reuses blocks by content and prefills the tail
        # only, which only the chunked path can do
        if enable_prefix_cache is None:
            enable_prefix_cache = self.chunked_prefill
        if enable_prefix_cache and not self.chunked_prefill:
            raise ValueError("the prefix cache needs chunked prefill "
                             "(bucketed prefill always recomputes from "
                             "position 0)")
        self.enable_prefix_cache = bool(enable_prefix_cache)
        # speculative decoding and int8 KV: the environment wins, as the
        # deploy-time switches of the JAX engine
        env_k = os.environ.get("PADDLE_SPEC_DECODE_K")
        if env_k not in (None, ""):
            try:
                k = int(env_k)
            except ValueError:
                raise ValueError(
                    f"PADDLE_SPEC_DECODE_K={env_k!r} is not an integer")
        else:
            k = int(spec_decode_k)
        if k < 0:
            raise ValueError(f"spec_decode_k must be >= 0, got {k}")
        self.spec_decode_k = k
        self.drafter = (drafter if drafter is not None else NgramDrafter()) \
            if k > 0 else None
        self.kv_dtype = _resolve_dtype_knob("PADDLE_SERVE_KV_DTYPE",
                                            kv_dtype)
        self.weight_dtype = _resolve_dtype_knob("PADDLE_SERVE_WEIGHT_DTYPE",
                                                weight_dtype)
        self.sampling = _resolve_bool_knob("PADDLE_SERVE_SAMPLING",
                                           sampling)
        self._seed_counter = 0
        # request-scoped tracing: host-side spans only, so a traced engine
        # launches what an untraced one does
        self.tracing = _resolve_bool_knob("PADDLE_SERVE_TRACING", tracing)
        self.tracer = TraceRecorder(capacity=trace_capacity) \
            if self.tracing else None
        # the async core: the decode or verify step stays in flight across
        # step() calls (one deep); its host rows ride pinned staging
        self.async_core = _resolve_bool_knob("PADDLE_SERVE_ASYNC",
                                             async_core)
        self._staged = self.async_core and self.device.type == "cuda"
        self._inflight = None          # the single in-flight step
        self._ahead = None             # (helper thread, results dict)
        self._next_drafts = {}         # slot -> draft from the helper
        self._step_seq = 0
        # the flight recorder and the step-phase clock are always on:
        # bounded host bookkeeping that feeds the leak audit's postmortem
        # and the host-gap histogram
        self.flight = FlightRecorder(capacity=flight_capacity)
        self._phases = PhaseTimer()
        # int8 weights: the snapshot the paged forwards read, one dict a
        # layer; None serves the live weights. Under a mesh the
        # tensor-parallel snapshot (`TensorParallel`, int8 or fp) instead
        self._qweights = None
        self._tp = None
        self.quantize_weights()
        # default pool: every slot at full context (+ the null block)
        self.cache = PagedKVCache(
            cfg.num_layers,
            int(num_blocks or 1 + self.num_slots * self.max_blocks),
            self.block_size, cfg.num_heads,
            cfg.hidden_size // cfg.num_heads, dtype=wte.dtype,
            device=self.device, kv_dtype=self.kv_dtype, mesh=self.mesh)
        # the hook holds the recorder, not the engine: a cycle through the
        # engine would keep its pools and model alive after the last
        # reference goes, until a full garbage collection
        flight = self.flight
        self.cache.on_evict = lambda b: flight.record("prefix_evict",
                                                      block=b)
        self._resolve_adapters(adapters, adapter_pool_pages, cfg, wte.dtype)
        if self.chunked_prefill:
            self.prefill_buckets = ()
        else:
            self.prefill_buckets = tuple(sorted(
                prefill_buckets or self._default_buckets()))
            if self.prefill_buckets[-1] < self.max_model_len:
                raise ValueError("largest prefill bucket "
                                 f"({self.prefill_buckets[-1]}) must "
                                 "cover max_model_len="
                                 f"{self.max_model_len}")
        self._queues = {p: deque() for p in PRIORITY_CLASSES}
        self._slots = [None] * self.num_slots
        self._results = {}
        self._draining = False
        self._auto_id = 0
        self._admit_counter = 0
        self.tokens_generated = 0
        self.admissions = 0
        self.prefix_hit_tokens = 0
        self.cow_copies = 0
        self.prefill_chunks = 0
        self.decode_steps = 0
        self.stalls = {"prefill": 0, "decode": 0, "admit": 0, "adapter": 0,
                       "spec_degrade": 0}
        self.shed = 0
        self.spec_accepted_tokens = 0
        self.spec_rejected_tokens = 0
        self.sampled_tokens = 0
        self.prefill_first_tokens = 0
        # serving telemetry: a registry of its own by default, so counts
        # stay exact with several engines in one process
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        self._init_metrics()

    # -- tensor-parallel serving (mesh) --------------------------------------
    def _resolve_mesh(self, mesh, mp_degree, cfg):
        """Resolve (mesh, mp_degree, env) to the serving mesh, as JAX's
        `_resolve_mesh`: `PADDLE_SERVE_MP` wins; an explicit mesh must
        agree with it and must carry an 'mp' axis; degree 1 means one
        device (no mesh). The default mesh is `serving_mesh(N)` on the
        engine's device type. Validates the Megatron divisibility
        constraints up front."""
        env = os.environ.get("PADDLE_SERVE_MP")
        env_mp = None
        if env not in (None, ""):
            try:
                env_mp = int(env)
            except ValueError:
                raise ValueError(
                    f"PADDLE_SERVE_MP={env!r} is not an integer")
        requested = env_mp if env_mp is not None else \
            (int(mp_degree) if mp_degree is not None else None)
        if mesh is not None:
            if "mp" not in getattr(mesh, "axis_names", ()):
                raise ValueError(
                    "serving mesh needs an 'mp' axis — build one with "
                    "distributed.serving_mesh(mp)")
            mesh_mp = mesh.shape["mp"]
            if requested is not None and requested != mesh_mp:
                raise ValueError(
                    f"mesh mp axis has {mesh_mp} devices but "
                    + ("PADDLE_SERVE_MP" if env_mp is not None
                       else "mp_degree")
                    + f"={requested} — drop one of the two")
            self.mp_degree = int(mesh_mp)
            self.mesh = mesh if self.mp_degree > 1 else None
        else:
            self.mp_degree = 1 if requested is None else int(requested)
            if self.mp_degree < 1:
                raise ValueError(
                    f"mp degree must be >= 1, got {self.mp_degree}")
            self.mesh = None if self.mp_degree == 1 else serving_mesh(
                self.mp_degree, devices=[self.device] * self.mp_degree
                if self.device.type == "cpu" else None)
        if self.mp_degree > 1:
            # fail HERE with the shape story, not deep in a per-shard
            # reshape (the serving_mesh contract, re-checked for an
            # explicitly passed mesh too)
            serving_mesh(self.mp_degree, num_heads=cfg.num_heads,
                         vocab_size=cfg.vocab_size,
                         devices=self.mesh.devices)
            if cfg.intermediate_size % self.mp_degree:
                raise ValueError(
                    f"intermediate_size={cfg.intermediate_size} is not "
                    f"divisible by mp degree {self.mp_degree} — cannot "
                    "column-shard the MLP")
            kinds = {d.type for d in self.mesh.devices}
            if kinds != {self.device.type}:
                raise ValueError(
                    f"the mesh's devices {sorted(kinds)} are not the "
                    f"engine's {self.device.type}")

    def _tp_plan(self):
        """id(parameter) -> (transform, shard axis 0): the Megatron
        column-parallel serving layout in torch's `[out, in]` terms. The
        qkv weight regroups head-major (`[heads, 3, D, H]`, its bias
        `[heads, 3, D]`) so that a contiguous heads slice holds complete
        (q, k, v) triples for ITS heads; out_proj, fc1 and fc2 shard
        their output rows (full-length dots, gathered activations: exact
        against mp=1, DESIGN_DECISIONS r12); wte shards its vocab rows.
        The layer norms and wpe replicate."""
        D = self.model.config.hidden_size // self.model.config.num_heads

        def qkv_w(w):                  # [3H, in] -> [heads, 3, D, in]
            return w.reshape(3, -1, D, w.shape[1]).permute(1, 0, 2, 3)

        def qkv_b(b):                  # [3H] -> [heads, 3, D]
            return b.reshape(3, -1, D).permute(1, 0, 2)

        gpt = self.model.gpt
        plan = {id(gpt.wte.weight): (None, 0)}
        for blk in gpt.blocks:
            attn, mlp = blk.attn, blk.mlp
            plan[id(attn.qkv_proj.weight)] = (qkv_w, 0)
            if attn.qkv_proj.bias is not None:
                plan[id(attn.qkv_proj.bias)] = (qkv_b, 0)
            for lin in (attn.out_proj, mlp.fc1, mlp.fc2):
                plan[id(lin.weight)] = (None, 0)
                if lin.bias is not None:
                    plan[id(lin.bias)] = (None, 0)
        return plan

    def _build_tp_state(self):
        """The tensor-parallel snapshot (`models.gpt.TensorParallel`): each
        parameter of `_tp_plan` transformed, split on its shard axis and
        copied to each shard's device in torch's serving layout (a
        weight's `[out / mp, in]` rows, a bias's `[out / mp]`); under
        `weight_dtype="int8"` each served weight is quantized per output
        channel on its ORIGINAL layout first, and its codes and scales
        take the weight's transform and split. The layer norms and wpe are
        copied once to each distinct device."""
        mesh, model = self.mesh, self.model
        mp = mesh.shape["mp"]
        plan = self._tp_plan()
        quant = {id(lin.weight) for layer in self._weight_quant_plan()
                 for lin in layer.values()} \
            if self.weight_dtype == "int8" else set()

        def copy(t, dev):
            return torch.empty(t.shape, dtype=t.dtype,
                               device=dev).copy_(t)

        def split(t, transform):
            g = t if transform is None else transform(t)
            n = g.shape[0] // mp
            return [copy(g[r * n:(r + 1) * n].reshape(-1, *t.shape[1:]),
                         dev) for r, dev in enumerate(mesh.devices)]

        def entries(lin):
            w, b = lin.weight.detach(), lin.bias
            t_w = plan[id(lin.weight)][0]
            bs = [None] * mp if b is None \
                else split(b.detach(), plan[id(b)][0])
            if id(lin.weight) not in quant:
                return list(zip(split(w, t_w), bs))
            q, sc = quantize_absmax(w, axis=0)
            return list(zip(split(q, t_w), split(sc, t_w), bs))

        gpt = model.gpt
        with torch.no_grad():
            wte = split(gpt.wte.weight.detach(), None)
            layers = [{name: entries(lin) for name, lin in layer.items()}
                      for layer in self._weight_quant_plan()]
            shards = [{"wte": wte[r],
                       "layers": [{name: e[r] for name, e in lay.items()}
                                  for lay in layers]}
                      for r in range(mp)]
            eps = model.config.layer_norm_epsilon

            def norm(ln, dev):
                return (copy(ln.weight.detach(), dev),
                        copy(ln.bias.detach(), dev))

            replicas = {dev: {"wpe": copy(gpt.wpe.weight.detach(), dev),
                              "ln1": [norm(b.ln1, dev) for b in gpt.blocks],
                              "ln2": [norm(b.ln2, dev) for b in gpt.blocks],
                              "ln_f": norm(gpt.ln_f, dev), "eps": eps}
                        for dev in mesh.distinct}
        return TensorParallel(mesh, shards, replicas)

    # -- multi-tenant adapter serving (paged batched LoRA) -----------------
    def _resolve_adapters(self, adapters, pages, cfg, dtype):
        """Wire the paged adapter pool: an AdapterRegistry builds a pool on
        the engine's device in the model's dtype (`adapter_pool_pages`
        pages, 1 + num_slots by default, so that a full batch of distinct
        tenants never stalls); a prebuilt PagedAdapterPool is adopted after
        a device, owner and geometry check. None turns the subsystem
        off."""
        if adapters is None:
            if pages is not None:
                raise ValueError(
                    "adapter_pool_pages needs adapters= (a registry "
                    "or pool) — pages of nothing would be a no-op")
            self.adapter_pool = None
            return
        if isinstance(adapters, PagedAdapterPool):
            if pages is not None:
                raise ValueError("adapter_pool_pages conflicts with a "
                                 "prebuilt PagedAdapterPool")
            if adapters.mesh != self.mesh:
                raise ValueError(
                    "the prebuilt adapter pool's mesh differs from "
                    "the engine's — build it with the engine's mesh "
                    "(or pass the registry and let the engine build "
                    "the pool)")
            if adapters.device != self.device:
                raise ValueError(
                    f"the prebuilt adapter pool lives on {adapters.device}, "
                    f"the engine on {self.device} — build it on the "
                    "engine's device (or pass the registry and let the "
                    "engine build the pool)")
            if adapters._owner is not None \
                    and adapters._owner is not self:
                raise ValueError(
                    "this PagedAdapterPool already pages for another "
                    "engine — paging state (refcounts/LRU/gauges) is "
                    "per-engine. Pass the AdapterRegistry instead and "
                    "let each engine build its own pool (the registry "
                    "is safely shared).")
            pool, reg = adapters, adapters.registry
        elif isinstance(adapters, AdapterRegistry):
            reg = adapters
            pool = PagedAdapterPool(
                reg, num_pages=int(pages) if pages is not None
                else 1 + self.num_slots, dtype=dtype, device=self.device,
                mesh=self.mesh)
        else:
            raise TypeError(
                "adapters= takes an AdapterRegistry or a "
                f"PagedAdapterPool, got {type(adapters).__name__}")
        for name, want in (("num_layers", cfg.num_layers),
                           ("hidden_size", cfg.hidden_size),
                           ("intermediate_size", cfg.intermediate_size),
                           ("num_heads", cfg.num_heads)):
            if getattr(reg, name) != want:
                raise ValueError(
                    f"adapter registry {name}={getattr(reg, name)} "
                    f"does not match the served model's {want}")
        pool._owner = self
        self.adapter_pool = pool

    def _check_adapter(self, adapter_id):
        """Validate an intake adapter id: 0 always passes (null/base);
        anything else needs the adapter subsystem on and the id
        registered."""
        aid = int(adapter_id)
        if aid == 0:
            return 0
        if self.adapter_pool is None:
            raise ValueError(
                f"adapter_id={aid} needs GenerationEngine("
                "adapters=...) — this engine serves the base model "
                "only")
        if not self.adapter_pool.registry.has(aid):
            raise ValueError(f"adapter {aid} is not registered")
        return aid

    def adapter_page_available(self, adapter_id):
        """True when seating a request under `adapter_id` would not stall
        on an adapter page right now (a placement probe, as `num_free`
        is for blocks)."""
        return self.adapter_pool is None or int(adapter_id) == 0 \
            or self.adapter_pool.can_acquire(adapter_id)

    @property
    def adapter_swapins(self):
        """Pages the adapter pool swapped in (0 without adapters)."""
        return 0 if self.adapter_pool is None else self.adapter_pool.swapins

    @property
    def adapter_evictions(self):
        """Warm pages the adapter pool evicted (0 without adapters)."""
        return 0 if self.adapter_pool is None \
            else self.adapter_pool.evictions

    def _acquire_adapter(self, req):
        """Take the adapter-page reference a request's lane needs (the null
        adapter is page 0, never paged). Returns the page, or None under
        adapter-pool pressure (a stall; the caller requeues and
        retries)."""
        if self.adapter_pool is None or not req.adapter_id:
            return 0
        with self._phase("adapter_swap"):
            swapins = self.adapter_pool.swapins
            page = self.adapter_pool.acquire(req.adapter_id)
        if page is None:
            self._stall(req, "adapter")
            return None
        if self.adapter_pool.swapins > swapins:
            # a cold page: the acquire copied the registry's stacks in
            self.flight.record("adapter_swap_in", req.req_id,
                               adapter=int(req.adapter_id), page=page)
            self._trace_instant("adapter.swap_in", req,
                                adapter=int(req.adapter_id), page=page)
        self._update_adapter_gauges()
        return page

    def _release_adapter(self, slot):
        """Return a vacating lane's adapter-page reference (the page parks
        warm in the pool's LRU at refcount zero)."""
        if self.adapter_pool is not None and slot.req.adapter_id:
            self.adapter_pool.release(slot.req.adapter_id)
            self._update_adapter_gauges()

    def _lora(self, slots):
        """The step's `LoraState` over `slots` (None for an idle lane,
        which rides the null page 0), or None without adapters; under a
        mesh one a shard, over its B columns."""
        if self.adapter_pool is None:
            return None
        pages = np.asarray([0 if s is None else s.adapter_page
                            for s in slots], np.int32)
        if self._tp is None:
            return LoraState(self.adapter_pool.arrays(),
                             self._to_device(pages))
        return [LoraState(self.adapter_pool.arrays(r), rows, head_major=True)
                for r, rows in enumerate(self._put(pages))]

    # -- serving telemetry ---------------------------------------------------
    def _init_metrics(self):
        """JAX's engine families (`_init_metrics` there), under its names,
        help strings (verbatim, so the two snapshots compare) and labels,
        but for the trace-count families of its
        compiled steps (`engine_decode_traces`, `engine_prefill_traces`,
        `engine_decode_recompiles_total`): an eager engine never
        retraces."""
        m = self.metrics
        self._m_ttft = m.histogram(
            "engine_ttft_seconds",
            "Request arrival to first generated token (includes queue "
            "wait and prefill), labeled by QoS priority class.",
            labelnames=("priority",), buckets=LATENCY_BUCKETS)
        self._m_tpot = m.histogram(
            "engine_tpot_seconds",
            "Per-output-token latency, labeled by QoS priority class: "
            "time since the slot's PREVIOUS token, so block-stall "
            "waits show up (not just the producing iteration's wall "
            "time). A request that only ever produces one token "
            "records that token's producing-step latency instead of "
            "staying invisible.",
            labelnames=("priority",), buckets=LATENCY_BUCKETS)
        self._m_queue = m.gauge(
            "engine_queue_depth", "Requests waiting for a slot.")
        self._m_active = m.gauge(
            "engine_active_slots", "Decode lanes currently occupied.")
        self._m_admissions = m.counter(
            "engine_admissions_total", "Requests admitted into a lane.")
        self._m_finished = m.counter(
            "engine_finished_total",
            "Requests finished (lane vacated).", labelnames=("reason",))
        # pool series carry this process's shard id, as JAX's carry
        # jax.process_index(), so per-rank snapshots merge side by side
        dist = torch.distributed
        self._shard = str(dist.get_rank()) if dist.is_available() \
            and dist.is_initialized() else "0"
        self._m_stalls = m.counter(
            "engine_block_stalls_total",
            "Iterations a lane/admission skipped for want of a pool "
            "block (path=spec_degrade: a speculative lane shed its "
            "draft window instead of skipping), labeled by engine "
            "shard.",
            labelnames=("path", "shard"))
        self._m_tokens = m.counter(
            "engine_tokens_generated_total", "New tokens emitted.")
        self._m_pool_used = m.gauge(
            "engine_pool_used_blocks",
            "KV pool blocks in use, by engine shard.",
            labelnames=("shard",)).labels(shard=self._shard)
        kv_name = self.kv_dtype or _dtype_name(self.cache.pool_spec()[1])
        self._m_pool_util = m.gauge(
            "engine_pool_utilization",
            "Used fraction of allocatable KV pool blocks, by engine "
            "shard and pool dtype (int8 = quantized KV serving).",
            labelnames=("shard", "kv_dtype")).labels(
                shard=self._shard, kv_dtype=kv_name)
        self._m_pool_bytes = m.gauge(
            "engine_pool_bytes",
            "Total bytes of the paged KV state (both pool planes plus "
            "the int8 per-block scale array when quantized), by shard "
            "and pool dtype — the capacity-claim number: int8 pools "
            "must come in at <= 0.55x their fp16/bf16 size.",
            labelnames=("shard", "kv_dtype")).labels(
                shard=self._shard, kv_dtype=kv_name)
        self._m_kv_dtype = m.gauge(
            "engine_kv_dtype_info",
            "Paged KV cache storage dtype this engine serves with "
            "(1 = selected).", labelnames=("kv_dtype",))
        self._m_kv_dtype.labels(kv_dtype=kv_name).set(1)
        w_name = self.weight_dtype or _dtype_name(
            self.model.gpt.wte.weight.dtype)
        self._m_weight_dtype = m.gauge(
            "engine_weight_dtype_info",
            "Served matmul-weight storage dtype (int8 = qkv/out/fc1/"
            "fc2 ride the compiled steps quantized; 1 = selected).",
            labelnames=("weight_dtype",))
        self._m_weight_dtype.labels(weight_dtype=w_name).set(1)
        self._m_pool_hw = m.gauge(
            "engine_pool_used_high_water_blocks",
            "High-water mark of KV pool blocks in use, by engine "
            "shard.",
            labelnames=("shard",)).labels(shard=self._shard)
        self._m_prefill_chunks = m.counter(
            "engine_prefill_chunks_total",
            "Compiled prefill-chunk dispatches (prefix-cache hits "
            "shrink this: hit tokens skip prefill compute).")
        self._m_hit_tokens = m.counter(
            "engine_prefix_cache_hit_tokens_total",
            "Prompt tokens served from the prefix cache instead of "
            "being recomputed.")
        self._m_cached_blocks = m.gauge(
            "engine_prefix_cached_blocks",
            "Pool blocks the prefix cache can currently serve hits "
            "from (live + evictable).")
        self._m_cow = m.counter(
            "engine_cow_copies_total",
            "Copy-on-write block promotions: a decode write landed in "
            "a shared/cached block and got a private copy first.")
        self._m_shed = m.counter(
            "engine_shed_total",
            "Requests shed at saturation (max_queue exceeded), by "
            "priority class.", labelnames=("priority",))
        self._m_spec_accepted = m.histogram(
            "engine_spec_accepted_tokens",
            "Tokens emitted per speculative verify step per lane "
            "(1 = no draft token survived; K+1 = the whole window "
            "accepted).",
            buckets=(1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 12.0, 16.0))
        self._m_spec_hit_rate = m.gauge(
            "engine_spec_draft_hit_rate",
            "Fraction of drafted tokens the target model confirmed "
            "(exact-acceptance matches / proposals) since the last "
            "registry reset.")
        # the hit rate's numerator and denominator live in the registry,
        # so a metrics.reset() restarts the rate
        spec_drafted = m.counter(
            "engine_spec_draft_tokens_total",
            "Drafted tokens offered to the verify step, by whether "
            "the target's argmax confirmed them.",
            labelnames=("result",))
        self._m_spec_ok = spec_drafted.labels(result="accepted")
        self._m_spec_rej = spec_drafted.labels(result="rejected")
        self._m_sampling = m.gauge(
            "engine_sampling_info",
            "Probabilistic serving state (1 = this engine threads "
            "per-slot sampling params through its compiled steps; "
            "greedy-only engines run the pre-sampling programs "
            "byte-identically).", labelnames=("enabled",))
        self._m_sampling.labels(
            enabled="1" if self.sampling else "0").set(1)
        # registered only when the subsystem is on, as in JAX
        self._m_sampled_tokens = None
        if self.sampling:
            self._m_sampled_tokens = m.counter(
                "engine_sampled_tokens_total",
                "Tokens emitted by sampled (temperature > 0) lanes — "
                "greedy lanes count only in "
                "engine_tokens_generated_total.")
        self._m_backend = m.gauge(
            "engine_attention_backend_info",
            "Paged-attention kernel backend the compiled decode step "
            "dispatches to (1 = selected).", labelnames=("backend",))
        self._m_backend.labels(backend=self.attention_backend).set(1)
        self._m_mesh = m.gauge(
            "engine_mesh_info",
            "Serving mesh the compiled steps span (1 = this "
            "configuration): tensor-parallel degree and device count.",
            labelnames=("mp_degree", "devices"))
        self._m_mesh.labels(
            mp_degree=str(self.mp_degree),
            devices=str(len(self.mesh.devices) if self.mesh is not None
                        else 1)).set(1)
        self._m_decode_seconds = m.histogram(
            "engine_decode_step_seconds",
            "Wall time of one compiled decode dispatch, labeled by "
            "paged-attention backend.", labelnames=("backend",),
            buckets=LATENCY_BUCKETS).labels(
                backend=self.attention_backend)
        # the host work of one step by named phase (always on)
        self._m_host_gap = m.histogram(
            "engine_step_host_gap_seconds",
            "Exclusive wall time one engine.step() spent in each named "
            "host phase (device_wait is the block_until_ready wait — "
            "the only phase that is device time; everything else is "
            "the serial host gap ROADMAP item 3 wants overlapped).",
            labelnames=("phase",), buckets=LATENCY_BUCKETS)
        self._m_device_fraction = m.gauge(
            "engine_step_device_fraction",
            "Fraction of the last step's wall time spent waiting on "
            "the device (device_wait / step wall): 1.0 = device-bound "
            "(host gap hidden), small = host-serial tax dominates.")
        # registered only with tracing on, as in JAX
        self._m_trace_spans = None
        if self.tracing:
            self._m_trace_spans = m.counter(
                "engine_trace_spans_total",
                "Spans/instants this engine's trace ring recorded "
                "(ring-bounded retention; see "
                "engine_trace_dropped_total).")
            self._m_trace_dropped = m.counter(
                "engine_trace_dropped_total",
                "Trace events evicted by the bounded span ring — "
                "nonzero means the exported timeline is a tail, not "
                "the full history.")
            self._trace_spans_seen = self._trace_dropped_seen = 0
        # per-tenant latency and adapter-pool paging, registered only with
        # adapters on, as in JAX
        self._m_a_ttft = self._m_a_tpot = None
        if self.adapter_pool is not None:
            self._m_a_ttft = m.histogram(
                "engine_adapter_ttft_seconds",
                "Request arrival to first token, labeled by tenant "
                "adapter id (0 = the null/base adapter) — the "
                "per-tenant SLO view of engine_ttft_seconds.",
                labelnames=("adapter",), buckets=LATENCY_BUCKETS)
            self._m_a_tpot = m.histogram(
                "engine_adapter_tpot_seconds",
                "Per-output-token latency by tenant adapter id — the "
                "per-tenant SLO view of engine_tpot_seconds.",
                labelnames=("adapter",), buckets=LATENCY_BUCKETS)
            self._m_a_pages = m.gauge(
                "engine_adapter_pool_pages",
                "Device-resident adapter pool pages (page 0 is the "
                "permanently-held null adapter).")
            self._m_a_pages.set(self.adapter_pool.num_pages)
            self._m_a_used = m.gauge(
                "engine_adapter_pool_used_pages",
                "Adapter pages referenced by live lanes (warm "
                "refcount-zero pages count as free capacity, like "
                "evictable KV blocks).")
            self._m_a_resident = m.gauge(
                "engine_adapter_pool_resident",
                "Adapters currently materialized on a page (live + "
                "warm LRU).")
            self._m_a_swapins = m.counter(
                "engine_adapter_swapins_total",
                "Host->device adapter page loads (an acquire missed "
                "the pool and copied the registry's stacks in).")
            self._m_a_evictions = m.counter(
                "engine_adapter_evictions_total",
                "Warm adapter pages evicted to make room for another "
                "tenant (LRU, refcount-zero only).")
            self._a_swapins_seen = self._a_evictions_seen = 0
            self._update_adapter_gauges()

    def _obs_ttft(self, req, v):
        """One TTFT observation on the priority-labelled series and, with
        adapters, the tenant-labelled one."""
        self._m_ttft.labels(priority=req.priority).observe(v)
        if self._m_a_ttft is not None:
            self._m_a_ttft.labels(adapter=str(req.adapter_id)).observe(v)

    def _obs_tpot(self, req, v):
        self._m_tpot.labels(priority=req.priority).observe(v)
        if self._m_a_tpot is not None:
            self._m_a_tpot.labels(adapter=str(req.adapter_id)).observe(v)

    def _update_adapter_gauges(self):
        pool = self.adapter_pool
        if pool is None:
            return
        # the static pages gauge too: a metrics.reset() must not leave it
        # at 0
        self._m_a_pages.set(pool.num_pages)
        self._m_a_used.set(pool.num_pages - 1 - pool.num_free)
        self._m_a_resident.set(pool.num_resident)
        if pool.swapins > self._a_swapins_seen:
            self._m_a_swapins.inc(pool.swapins - self._a_swapins_seen)
            self._a_swapins_seen = pool.swapins
        if pool.evictions > self._a_evictions_seen:
            self._m_a_evictions.inc(pool.evictions - self._a_evictions_seen)
            self._a_evictions_seen = pool.evictions

    def _update_pool_gauges(self):
        # "used" = referenced blocks; refcount-zero cached blocks are
        # reclaimable on demand, so they count as free capacity
        used = self.cache.num_blocks - 1 - self.cache.num_free
        self._m_pool_used.set(used)
        self._m_pool_util.set(used / max(self.cache.num_blocks - 1, 1))
        self._m_pool_bytes.set(self.cache.pool_nbytes())
        self._m_pool_hw.set_max(used)
        self._m_cached_blocks.set(self.cache.num_cached_blocks)

    def _end_of_step_gauges(self):
        self._m_active.set(self.num_active)
        self._m_queue.set(self.num_pending)
        self._update_pool_gauges()
        self._update_adapter_gauges()
        if self._m_trace_spans is not None:
            total = self.tracer.total_recorded
            self._m_trace_spans.inc(total - self._trace_spans_seen)
            self._trace_spans_seen = total
            dropped = self.tracer.dropped
            self._m_trace_dropped.inc(dropped - self._trace_dropped_seen)
            self._trace_dropped_seen = dropped

    def metrics_snapshot(self):
        """JSON-able snapshot of this engine's serving metrics."""
        return self.metrics.snapshot()

    def render_prometheus(self):
        """This engine's metrics in the Prometheus text format."""
        return self.metrics.render_prometheus()

    # -- request-scoped tracing, step phases, flight recorder ----------------
    def _phase(self, name):
        """Enter one named host phase of the current step (exclusive
        accounting: a nested phase pauses the enclosing one) and, with
        tracing on, record it as a span."""
        if self.tracer is None:
            return self._phases.phase(name)
        return self._traced_phase(name)

    @contextmanager
    def _traced_phase(self, name):
        t0 = now_us()
        with self._phases.phase(name):
            yield
        self.tracer.add_span("phase." + name, t0, now_us(), cat="phase")

    def _trace_span(self, name, start_us, req=None, tid=0, cat="request",
                    **attrs):
        """Close a request-scoped span started at `start_us` (a no-op
        with tracing off)."""
        if self.tracer is None:
            return
        self.tracer.add_span(
            name, start_us, now_us(), tid=tid, cat=cat,
            trace_id=None if req is None else req.trace_id,
            args={"req_id": str(req.req_id), **attrs} if req is not None
            else (attrs or None))

    def _trace_instant(self, name, req=None, **attrs):
        if self.tracer is None:
            return
        self.tracer.add_instant(
            name, cat="request",
            trace_id=None if req is None else req.trace_id,
            args={"req_id": str(req.req_id), **attrs} if req is not None
            else (attrs or None))

    def _flush_step_phases(self, wall):
        """Fold the finished step's phase clock into the host-gap
        histogram and the device-fraction gauge."""
        totals = self._phases.reset()
        if not totals:
            return
        for phase, dt in totals.items():
            self._m_host_gap.labels(phase=phase).observe(dt)
        dev = totals.get("device_wait", 0.0)
        self._m_device_fraction.set(
            min(dev / wall, 1.0) if wall > 0 else 0.0)

    def dump_flight_recorder(self):
        """The bounded ring of recent request-lifecycle events (oldest
        first, JSON-able): the postmortem `drain()`'s leak audit
        attaches."""
        return self.flight.dump()

    def _audit_error(self, msg):
        """A drain-audit failure with the flight recorder's history
        attached."""
        return RuntimeError(msg + "\n" + self.flight.format(limit=64))

    def export_trace(self, path, include_profiler=True):
        """Write this engine's span ring as one Chrome trace-event /
        Perfetto JSON timeline, merged (same monotonic clock) with the
        spans the port's profiler has buffered. Returns the event
        count written."""
        if self.tracer is None:
            raise RuntimeError(
                "tracing is off — build the engine with tracing=True "
                "(or PADDLE_SERVE_TRACING=1) to record spans")
        groups = [("engine", self.tracer.snapshot())]
        if include_profiler:
            ev = profiler_host_events()
            if ev:
                groups.append(("profiler", ev))
        return export_timeline(path, groups)

    # -- int8 weight serving -----------------------------------------------
    def _weight_quant_plan(self):
        """The weights served int8, one dict a layer of name -> Linear:
        the attention's qkv and out and the MLP's fc1 and fc2 (the
        per-step weight read). Embeddings, norms, biases and the tied
        head stay fp. Under a mesh their codes and per-output-channel
        scales take the weight's `_tp_plan` grouping (qkv head-major) and
        split, so scales shard exactly like their rows."""
        return [{"qkv_proj": b.attn.qkv_proj, "out_proj": b.attn.out_proj,
                 "fc1": b.mlp.fc1, "fc2": b.mlp.fc2}
                for b in self.model.gpt.blocks]

    def _build_quant_state(self):
        """The int8 snapshot: each planned weight as (codes, per-output-
        channel scale) from `quantize_absmax` over torch's `[out, in]`
        (JAX's `axis=1` over its `[in, out]`)."""
        with torch.no_grad():
            return [{name: quantize_absmax(lin.weight.detach(), axis=0)
                     for name, lin in layer.items()}
                    for layer in self._weight_quant_plan()]

    def quantize_weights(self):
        """(Re)build the served weight snapshot: the tensor-parallel one
        under a mesh (fp or int8), else the int8 one under
        `weight_dtype="int8"`; a no-op for the fp engine on one device,
        which reads the live weights."""
        if self.mesh is not None:
            self._tp = self._build_tp_state()
        elif self.weight_dtype == "int8":
            self._qweights = self._build_quant_state()

    def refresh_weights(self):
        """Re-snapshot (re-shard and/or re-quantize) the served weights
        from the live parameters: call after a weight update (an fp engine
        on one device never needs it)."""
        self.quantize_weights()

    def weight_snapshot_nbytes(self):
        """Bytes of the snapshot's weight matrices: the int8 codes on one
        device; under a mesh every shard's qkv, out, fc1 and fc2 rows
        (codes or fp) and wte rows. 0 for an fp engine on one device."""
        if self._tp is not None:
            return sum(t.numel() * t.element_size()
                       for sh in self._tp.shards
                       for t in [sh["wte"]] + [e[0] for lay in sh["layers"]
                                               for e in lay.values()])
        return sum(q.numel() * q.element_size()
                   for layer in self._qweights or ()
                   for q, _ in layer.values())

    # -- per-slot sampling ---------------------------------------------------
    def _check_sampling(self, params):
        """Validate intake sampling params: None always passes (the greedy
        contract); anything else needs `sampling=True`. Returns the params
        unchanged (the seed may still be None)."""
        if params is None:
            return None
        if not isinstance(params, SamplingParams):
            raise TypeError(
                "sampling_params takes a SamplingParams, got "
                f"{type(params).__name__}")
        if not self.sampling:
            raise ValueError(
                "sampling_params needs GenerationEngine(sampling=True) "
                "— this engine decodes greedily")
        return params

    def _resolve_seed(self, params):
        """Pin a request's seed: explicit seeds pass through, None draws
        from the engine's deterministic counter (same admission order,
        same seeds, same tokens)."""
        if params is None or params.seed is not None:
            return params
        seed = self._seed_counter
        self._seed_counter += 1
        return params.with_seed(seed)

    @staticmethod
    def _slot_sampling_fields(req):
        """The per-slot sampling state a request seats with: greedy (or
        param-less) lanes keep the inert defaults."""
        p = req.sampling
        if p is None or p.greedy:
            return {}
        return dict(temp=float(p.temperature), top_k=int(p.top_k),
                    top_p=float(p.top_p), key_row=key_row(p.seed))

    def _sampling_rows(self, slots):
        """The per-row sampling tensors of one step over `slots` (None for
        an idle lane) on the device: temperature, top-k, top-p `[rows]`
        and the key rows `[rows, 2]`. Idle and greedy lanes ride
        temperature 0 and zero keys: their draws are never selected."""
        n = len(slots)
        temps = np.zeros(n, np.float32)
        tks = np.zeros(n, np.int32)
        tps = np.ones(n, np.float32)
        keys = np.zeros((n, 2), np.int64)
        for i, slot in enumerate(slots):
            if slot is None or slot.key_row is None:
                continue
            temps[i], tks[i], tps[i] = slot.temp, slot.top_k, slot.top_p
            keys[i] = slot.key_row.numpy()
        return [self._to_device(a) for a in (temps, tks, tps, keys)]

    # -- request intake ----------------------------------------------------
    def add_request(self, prompt, max_new_tokens, eos_token_id=None,
                    req_id=None, priority="standard", sampling_params=None,
                    adapter_id=0, trace_id=None):
        """Queue a request; it is admitted into a free lane between steps
        (may be called while `run`/`step` is mid-stream). With `max_queue`
        set and the queue full, the lowest-priority loser is shed: its
        result is None. `sampling_params` (a `SamplingParams`; needs
        `sampling=True`) samples the request; None and temperature 0 keep
        the greedy contract. A None seed is drawn here from the engine's
        deterministic counter. `adapter_id` is the tenant adapter the
        request decodes under (needs `adapters=`; 0, the default, is the
        base model). `trace_id` names the request's spans (with tracing
        on, a fresh one when None). Returns the request id."""
        adapter_id = self._check_adapter(adapter_id)
        sampling_params = self._resolve_seed(
            self._check_sampling(sampling_params))
        if self._draining:
            raise RuntimeError("engine is draining — admissions are closed")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if priority not in PRIORITY_CLASSES:
            raise ValueError(f"priority must be one of "
                             f"{PRIORITY_CLASSES}, got {priority!r}")
        total = prompt.size + int(max_new_tokens)
        if total > self.max_model_len:
            raise ValueError(
                f"prompt({prompt.size}) + max_new({max_new_tokens}) = "
                f"{total} exceeds max_model_len={self.max_model_len}")
        live = self._in_flight()
        if req_id is None:
            while self._auto_id in live:   # skip live caller-chosen ids
                self._auto_id += 1
            req_id = self._auto_id
            self._auto_id += 1
        elif req_id in live:
            raise ValueError(f"req_id {req_id!r} is already queued, "
                             "decoding, or awaiting collection")
        eos = self.eos_token_id if eos_token_id is None else eos_token_id
        if self.tracing and trace_id is None:
            trace_id = new_trace_id()
        req = Request(req_id, prompt, int(max_new_tokens), eos,
                      arrived_at=time.perf_counter(), priority=priority,
                      sampling=sampling_params, adapter_id=adapter_id,
                      trace_id=trace_id)
        self.flight.record("queued", req_id, priority=priority,
                           plen=int(prompt.size), adapter=int(adapter_id))
        self._trace_instant("request.queued", req, priority=priority,
                            plen=int(prompt.size))
        if self.max_queue is not None \
                and self.num_pending >= self.max_queue:
            victim = self._shed_victim(priority)
            if victim is None:         # incoming ranks no better: shed it
                self._shed(req)
                return req_id
            self._shed(victim)
        self._queues[priority].append(req)
        self._m_queue.set(self.num_pending)
        return req_id

    def _shed_victim(self, incoming_priority):
        """Worst queued request STRICTLY below the incoming class (newest
        within it), or None when the incoming request is the one to shed."""
        rank = PRIORITY_CLASSES.index(incoming_priority)
        for p in reversed(PRIORITY_CLASSES[rank + 1:]):
            if self._queues[p]:
                return self._queues[p].pop()
        return None

    def _shed(self, req):
        self._results[req.req_id] = None
        self.shed += 1
        self._m_shed.labels(priority=req.priority).inc()
        self._m_queue.set(self.num_pending)
        self.flight.record("shed", req.req_id, priority=req.priority)
        self._trace_instant("request.shed", req, priority=req.priority)

    def _in_flight(self):
        ids = {r.req_id for p in PRIORITY_CLASSES for r in self._queues[p]}
        ids.update(s.req.req_id for s in self._slots if s is not None)
        ids.update(self._results)
        return ids

    def _peek_request(self):
        for p in PRIORITY_CLASSES:
            if self._queues[p]:
                return self._queues[p][0]
        return None

    def _pop_request(self):
        req = self._peek_request()
        if req is not None:
            self._queues[req.priority].popleft()
        return req

    # -- scheduler ---------------------------------------------------------
    def _note_tokens(self, req, n=1):
        """Account `n` freshly emitted tokens: the counters and series,
        sampled (temperature > 0) lanes' apart too."""
        self.tokens_generated += n
        self._m_tokens.inc(n)
        if req.sampling is not None and not req.sampling.greedy:
            self.sampled_tokens += n
            self._m_sampled_tokens.inc(n)

    def _stall(self, req, path):
        """Count a stall of `req` on `path`: the plain counter, the series
        and the flight recorder."""
        self.stalls[path] += 1
        self._m_stalls.labels(path=path, shard=self._shard).inc()
        self.flight.record("stall", req.req_id, path=path)

    def _finish(self, slot, reason):
        """Retire a lane's request: its result, its blocks back to the
        pool, its adapter page released. The caller vacates the lane."""
        req = slot.req
        self._results[req.req_id] = \
            list(map(int, req.prompt)) + slot.generated
        self.cache.free(slot.blocks)
        self._release_adapter(slot)
        self._m_finished.labels(reason=reason).inc()
        self.flight.record("finish", req.req_id, reason=reason,
                           tokens=len(slot.generated))
        self._trace_instant("request.finish", req, reason=reason,
                            tokens=len(slot.generated))

    def _first_token(self, slot, first, t_step):
        """Seat a request's first generated token (from the final prefill
        chunk or a bucketed prefill): TTFT, token accounting, prefix-cache
        publication, and retirement of an instant finisher. Returns False
        when the lane was vacated."""
        req = slot.req
        now = time.perf_counter()
        slot.generated.append(first)
        slot.last_token_at = now
        self._note_tokens(req)
        self.flight.record("first_token", req.req_id)
        self._trace_instant("request.first_token", req)
        if req.arrived_at is not None:
            self._obs_ttft(req, now - req.arrived_at)
        if self.enable_prefix_cache:
            # the prompt's KV is fully written: publish its full blocks
            # under the request's adapter-salted chain
            self.cache.register_prefix(req.prompt, slot.blocks,
                                       adapter_id=req.adapter_id)
        done_eos = (req.eos_token_id is not None
                    and first == req.eos_token_id)
        if done_eos or req.max_new_tokens == 1:
            # an instant finisher's only token still lands in the TPOT
            # histogram (the producing step's latency)
            self._obs_tpot(req, now - t_step)
            self._finish(slot, "eos" if done_eos else "length")
            self._slots[self._slots.index(slot)] = None
            return False
        return True

    def _admit_chunked(self):
        """Seat queued requests into free lanes: match the longest cached
        block-aligned prefix (read-only references) and leave the tail to
        the chunked prefill. A full-prefix hit enters decode directly."""
        admitted = 0
        with self._phase("schedule"):
            while None in self._slots:
                req = self._pop_request()
                if req is None:
                    break
                page = self._acquire_adapter(req)
                if page is None:
                    # every adapter page is referenced by a live lane:
                    # requeue at the front and retry when a lane vacates
                    self._queues[req.priority].appendleft(req)
                    break
                blocks, hit = [], 0
                if self.enable_prefix_cache:
                    with self._phase("prefix_lookup"):
                        blocks, hit = self.cache.match_prefix(
                            req.prompt, adapter_id=req.adapter_id)
                    if hit:
                        self.prefix_hit_tokens += hit
                        self._m_hit_tokens.inc(hit)
                slot = _Slot(req=req, blocks=list(blocks), prefill_pos=hit,
                             hit_tokens=hit, admit_seq=self._admit_counter,
                             adapter_page=page,
                             **self._slot_sampling_fields(req))
                self._admit_counter += 1
                self._slots[self._slots.index(None)] = slot
                self.admissions += 1
                self._m_admissions.inc()
                self.flight.record("admitted", req.req_id, hit_tokens=hit)
                self._trace_instant("request.admitted", req,
                                    hit_tokens=hit)
                self._update_pool_gauges()
                admitted += 1
        self._m_queue.set(self.num_pending)
        return admitted

    def _default_buckets(self):
        """JAX's ladder: 16, 32, 64, ... below `max_model_len`, then
        `max_model_len` itself."""
        b, out = 16, []
        while b < self.max_model_len:
            out.append(b)
            b *= 2
        out.append(self.max_model_len)
        return out

    def _bucket_for(self, plen):
        for b in self.prefill_buckets:
            if b >= plen:
                return b
        raise AssertionError("unreachable: last bucket covers "
                             "max_model_len")

    def _admit(self):
        """Bucketed admission: fill free lanes from the queue (priority
        order), each taking its prompt's blocks, then its adapter page (a
        block stall must not burn a swap-in), then running the whole
        prompt padded to its bucket through `forward_prefill`; the KV
        lands in the blocks (`paged_prefill_write`), the last real
        position's logits give the first generated token, and the slot
        enters decode."""
        admitted = 0
        while None in self._slots:
            req = self._peek_request()
            if req is None:
                break
            plen = int(req.prompt.size)
            with self._phase("schedule"):
                need = math.ceil(plen / self.block_size)
                blocks = self.cache.allocate(need)
            if blocks is None:
                self._stall(req, "admit")
                break                      # pool pressure: retry later
            self._update_pool_gauges()     # the high-water sees the peak
            page = self._acquire_adapter(req)
            if page is None:
                self.cache.free(blocks)    # fresh, unhashed: free list
                self._update_pool_gauges()
                break                      # adapter pressure: retry later
            self._pop_request()
            bucket = self._bucket_for(plen)
            slot = _Slot(req=req, blocks=blocks, prefill_pos=plen,
                         admit_seq=self._admit_counter, adapter_page=page,
                         **self._slot_sampling_fields(req))
            self._admit_counter += 1
            self._slots[self._slots.index(None)] = slot
            self.admissions += 1
            self._m_admissions.inc()
            self.flight.record("admitted", req.req_id, bucket=bucket)
            self._trace_instant("request.admitted", req, bucket=bucket)
            admitted += 1
            t_span = now_us()
            with self._phase("dispatch"):
                tokens = np.zeros((1, bucket), np.int32)
                tokens[0, :plen] = req.prompt
                row = np.zeros(self.max_blocks, np.int32)
                row[:need] = blocks
                kp, vp, sc = self._pools()
                with RecordEvent("engine.prefill"), torch.no_grad():
                    t0 = time.perf_counter()
                    hidden, ks, vs = self.model.gpt.forward_prefill(
                        self._put(tokens), self._qweights,
                        self._lora([slot]), tp=self._tp)
                    (paged_prefill_write if self._tp is None
                     else paged_prefill_write_shards)(
                        kp, vp, ks, vs, self._put(row), plen, sc)
                    first = self._first_of(self._row(hidden, (0, plen - 1)),
                                           slot, plen)
                    with self._phase("device_wait"):
                        first = int(first)     # sync: the first token
            self._trace_span("prefill.bucketed", t_span, req=req,
                             bucket=bucket)
            with self._phase("finish"):
                self._first_token(slot, first, t0)
        self._m_queue.set(self.num_pending)
        return admitted

    def _first_of(self, h_last, slot, plen):
        """A prompt's first generated token, on the device, from its last
        real position's hidden state: the argmax, or under sampling a draw
        that folds `plen - 1` (the key a full-prefix-hit decode would fold
        for it)."""
        logits = self.model._logits_of(h_last, self._tp)
        self.prefill_first_tokens += 1
        if not self.sampling:
            return logits.argmax(-1)
        return sample_token(
            logits[None], *self._sampling_rows([slot]),
            self._to_device(np.asarray([plen - 1], np.int32)))[0]

    def _to_device(self, arr):
        """A host array on the engine's device: one copy that waits, in
        the serial core; in the async core on a card, a copy from pinned
        staging issued without a wait, so that no host sync lands behind
        a step in flight (the caching host allocator keeps the staging
        block until the copy has run)."""
        t = torch.from_numpy(arr)
        if self._staged:
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _put(self, arr):
        """A host array as the model's forwards take it: on the engine's
        device, or under a mesh on every shard's (a per-shard list)."""
        if self._tp is None:
            return self._to_device(arr)
        return self._tp.put(arr, non_blocking=self._staged)

    def _pools(self):
        """The cache's (K pools, V pools, scales) as the forwards take
        them: tensors, or under a mesh per-shard lists."""
        c = self.cache
        if self._tp is None:
            return c.kpool, c.vpool, c.scales
        return c.kpools, c.vpools, c.scale_shards

    def _row(self, hidden, index):
        """`hidden[index]`, of every shard's replica under a mesh."""
        if self._tp is None:
            return hidden[index]
        return [h[index] for h in hidden]

    def _first_shard(self, t):
        return t if self._tp is None else t[0]

    def _prefill_step(self):
        """Run at most ONE prefill chunk: the neediest prefilling lane
        (priority, then admission order) allocates the chunk's blocks and
        pushes `prefill_chunk` prompt positions through the model; the
        final chunk yields the first generated token. A lane that cannot
        get blocks stalls and the next candidate gets the chunk."""
        with self._phase("schedule"):
            cands = [s for s in self._slots
                     if s is not None and s.prefilling]
            cands.sort(key=lambda s: (
                PRIORITY_CLASSES.index(s.req.priority), s.admit_seq))
        C = self.prefill_chunk
        for slot in cands:
            req = slot.req
            plen = int(req.prompt.size)
            start = slot.prefill_pos
            end = min(start + C, plen)
            with self._phase("schedule"):
                need = math.ceil(end / self.block_size) - len(slot.blocks)
                if need > 0:
                    got = self.cache.allocate(need)
                    if got is None:
                        self._stall(req, "prefill")
                        continue       # pool pressure: next candidate
                    slot.blocks.extend(got)
                    self._update_pool_gauges()
            t_span = now_us()
            with self._phase("dispatch"):
                tokens = np.zeros((1, C), np.int32)
                tokens[0, :end - start] = req.prompt[start:end]
                row = np.zeros(self.max_blocks, np.int32)
                row[:len(slot.blocks)] = slot.blocks
                kp, vp, sc = self._pools()
                with RecordEvent("engine.prefill"), torch.no_grad():
                    t0 = time.perf_counter()
                    hidden = self.model.gpt.forward_prefill_chunk(
                        self._put(tokens), start, kp, vp, self._put(row),
                        plen, sc, self._qweights, self._lora([slot]),
                        tp=self._tp)
                    self.prefill_chunks += 1
                    self._m_prefill_chunks.inc()
                    slot.prefill_pos = end
                    if end < plen:     # mid-prompt: nothing to read
                        self._trace_span("prefill.chunk", t_span, req=req,
                                         start=start, end=end)
                        return 1
                    # the last real prompt position gives the first token
                    first = self._first_of(
                        self._row(hidden, (0, plen - 1 - start)), slot,
                        plen)
                    with self._phase("device_wait"):
                        first = int(first)     # sync: the first token
            self._trace_span("prefill.chunk", t_span, req=req, start=start,
                             end=end, final=True)
            with self._phase("finish"):
                self._first_token(slot, first, t0)
            return 1
        return 0

    def _cow_promote(self, slot, bi, count_stall=True):
        """Give `slot` a private copy of its table entry `bi` (a write is
        about to land there and other owners still read it). Returns False
        when the pool cannot serve the copy (the lane stalls;
        `count_stall=False` when the caller has a degrade path and the lane
        may still run)."""
        got = self.cache.allocate(1)
        if got is None:
            if count_stall:
                self._stall(slot.req, "decode")
            return False
        src, dst = slot.blocks[bi], got[0]
        with self._phase("cow"), RecordEvent("engine.cow"):
            # every shard's rows; int8 pools: the block's grid rides along
            self.cache.copy_block(src, dst)
        self.cache.free([src])         # drop our shared reference
        slot.blocks[bi] = dst
        self.cow_copies += 1
        self._m_cow.inc()
        self._update_pool_gauges()
        return True

    def _decode_step(self):
        """One batched decode step over the runnable lanes, serial core:
        schedule, dispatch and complete in this one call. Idle and stalled
        lanes ride token 0, position 0 and an all-zero table: they write
        the null block and their tokens are discarded. With K > 0 the step
        is the speculative verify step. The async core drives the same
        stages through `_dispatch_ahead` and `_complete_inflight`."""
        if self.spec_decode_k:
            runnable, drafts = self._spec_schedule()
            if not runnable:
                return 0
            inflight = self._spec_dispatch(runnable, drafts)
            return self._spec_complete(inflight, synced=False)
        runnable = self._plain_schedule()
        if not runnable:
            return 0
        inflight = self._plain_dispatch(runnable)
        return self._plain_complete(inflight, synced=False)

    def _plain_schedule(self):
        """Schedule stage of a decode step: on-demand block growth +
        copy-on-write per decode-phase lane; returns the runnable lane
        indices."""
        runnable = []
        with self._phase("schedule"):
            for i, slot in enumerate(self._slots):
                if slot is None or slot.prefilling:
                    continue
                bi = slot.feed_pos // self.block_size
                if bi >= len(slot.blocks):
                    got = self.cache.allocate(1)
                    if got is None:
                        self._stall(slot.req, "decode")
                        continue       # stalled this iteration
                    slot.blocks.extend(got)
                    self._update_pool_gauges()
                elif self.cache.needs_cow(slot.blocks[bi]):
                    if not self._cow_promote(slot, bi):
                        continue
                runnable.append(i)
        return runnable

    def _lane_slots(self, runnable):
        """Each lane's slot if it runs this step, else None (idle and
        stalled lanes ride the null adapter page)."""
        run = set(runnable)
        return [s if i in run else None for i, s in enumerate(self._slots)]

    def _readback(self, outs):
        """Start reading a step's token tensors back. The async core on a
        card copies them into pinned host memory without a wait and
        records an event after the copies, on the device that holds them
        (the gathered logits' under a mesh): `(host copies, event)`. Else
        `(None, None)`: the complete stage reads them itself."""
        if not self._staged:
            return None, None
        host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                     for o in outs)
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(outs[0].device))
        return host, event

    def _host_tokens(self, inflight, synced):
        """A dispatched step's token outputs as numpy arrays. Serial core
        (`synced=False`): the copy to the host is the device wait,
        clocked as `device_wait`. Async core: `_complete_inflight` has
        already waited on the step's event, and this is a host read."""
        if synced:
            return [t.numpy() for t in (inflight.host or inflight.out)]
        with self._phase("device_wait"):
            return [t.cpu().numpy() for t in inflight.out]

    def _plain_dispatch(self, runnable):
        """Dispatch stage of a decode step: the host rows to the device,
        the forward and the pick, and the start of the token readback,
        without waiting on the device. Returns the `_InFlight` record the
        complete stage takes."""
        t_span = now_us()
        with self._phase("dispatch"):
            tokens = np.zeros((self.num_slots, 1), np.int32)
            positions = np.zeros(self.num_slots, np.int32)
            tables = np.zeros((self.num_slots, self.max_blocks), np.int32)
            for i in runnable:
                slot = self._slots[i]
                tokens[i, 0] = slot.feed_token
                positions[i] = slot.feed_pos
                tables[i, :len(slot.blocks)] = slot.blocks
            kp, vp, sc = self._pools()
            with RecordEvent("engine.decode"), torch.no_grad():
                t_dec = time.perf_counter()
                pos = self._put(positions)
                hidden = self.model.gpt.forward_decode_paged(
                    self._put(tokens), pos, kp, vp, self._put(tables), sc,
                    self.attention_backend, self._qweights,
                    self._lora(self._lane_slots(runnable)), tp=self._tp)
                logits = self.model._logits_of(hidden, self._tp)[:, 0]
                if self.sampling:
                    # greedy rows take the argmax, sampled rows one draw
                    # keyed by (seed, the feed position)
                    nxt = sample_token(logits,
                                       *self._sampling_rows(self._slots),
                                       self._first_shard(pos))
                else:
                    nxt = logits.argmax(-1)
                host, event = self._readback((nxt,))
        self.decode_steps += 1
        self._step_seq += 1
        return _InFlight(out=(nxt,), runnable=runnable,
                         slots=[self._slots[i] for i in runnable],
                         host=host, event=event, t_dec=t_dec,
                         t_span=t_span, seq=self._step_seq)

    def _plain_complete(self, inflight, synced):
        """Complete stage of a decode step: the token readback (see
        `_host_tokens`), then the per-lane emission, latency accounting
        and retirement."""
        nxt, = self._host_tokens(inflight, synced)
        self._m_decode_seconds.observe(time.perf_counter() - inflight.t_dec)
        self._trace_span("decode.step", inflight.t_span, cat="engine",
                         lanes=len(inflight.runnable))
        t_dec = inflight.t_dec
        now = time.perf_counter()
        with self._phase("finish"):
            for i, slot in zip(inflight.runnable, inflight.slots):
                tok = int(nxt[i])
                is_first = not slot.generated   # a full-prefix-hit lane
                slot.generated.append(tok)
                req = slot.req
                self._note_tokens(req)
                if is_first:
                    # this decode gave the request's first token (its whole
                    # prompt came from the prefix cache)
                    if req.arrived_at is not None:
                        self._obs_ttft(req, now - req.arrived_at)
                    self.flight.record("first_token", req.req_id)
                    self._trace_instant("request.first_token", req)
                elif slot.last_token_at is not None:
                    # the lane's own gap, stalled iterations included
                    self._obs_tpot(req, now - slot.last_token_at)
                slot.last_token_at = now
                done_eos = req.eos_token_id is not None \
                    and tok == req.eos_token_id
                if done_eos or len(slot.generated) >= req.max_new_tokens:
                    if is_first:
                        self._obs_tpot(req, now - t_dec)
                    self._finish(slot, "eos" if done_eos else "length")
                    self._slots[i] = None
        return len(inflight.runnable)

    def _spec_schedule(self):
        """Schedule stage of a verify step: draft up to K tokens per
        decode-phase lane (on the host, or joined from the async core's
        drafter thread through `_next_drafts`), then grow the table to the
        window's last write and copy-on-write every block the window
        writes. Under pool pressure a lane sheds its draft (a
        `spec_degrade` stall: it still runs a one-token window) before it
        stalls; when the COW copy fails mid-window it also returns the
        surplus tail blocks past its feed block, which only ever held
        rejected rows. Returns (runnable lane indices, lane -> draft)."""
        K = self.spec_decode_k
        bs = self.block_size
        vocab = self.model.config.vocab_size
        runnable, drafts = [], {}
        with self._phase("schedule"):
            for i, slot in enumerate(self._slots):
                if slot is None or slot.prefilling:
                    continue
                req = slot.req
                # emitted tokens cap at the request's allowance, and the
                # last write position stays inside the model's length
                budget = min(K, req.max_new_tokens - len(slot.generated) - 1,
                             self.max_model_len - 1 - slot.feed_pos)
                draft = []
                if budget > 0:
                    with self._phase("draft_propose"):
                        # the helper thread proposed from the same context
                        # (async core); lanes it did not see propose here
                        draft = self._next_drafts.pop(slot, None)
                        if draft is None:
                            draft = draft_window(self.drafter, req.prompt,
                                                 slot.generated, budget,
                                                 vocab)
                stalled = False
                while True:
                    need = (slot.feed_pos + len(draft)) // bs + 1 \
                        - len(slot.blocks)
                    if need <= 0:
                        break
                    got = self.cache.allocate(need)
                    if got is not None:
                        slot.blocks.extend(got)
                        self._update_pool_gauges()
                        break
                    if not draft:
                        self._stall(req, "decode")
                        stalled = True
                        break
                    draft = []         # degrade: draftless step
                    self._stall(req, "spec_degrade")
                if stalled:
                    continue
                if not self._cow_window(slot, len(draft),
                                        count_stall=False):
                    feed_bi = slot.feed_pos // bs
                    surplus = slot.blocks[feed_bi + 1:]
                    if surplus:
                        del slot.blocks[feed_bi + 1:]
                        self.cache.free(surplus)
                        self._update_pool_gauges()
                    if draft:
                        draft = []
                        self._stall(req, "spec_degrade")
                    if not self._cow_window(slot, 0, count_stall=True):
                        continue       # truly stalled this iteration
                drafts[i] = draft
                runnable.append(i)
        return runnable, drafts

    def _cow_window(self, slot, k_len, count_stall):
        """Copy-on-write every block a window of `k_len` drafts writes: a
        speculative write must never land in a block other owners (or the
        prefix cache) still read. False when a copy could not be served."""
        bs = self.block_size
        for bi in range(slot.feed_pos // bs,
                        (slot.feed_pos + k_len) // bs + 1):
            if self.cache.needs_cow(slot.blocks[bi]) and not \
                    self._cow_promote(slot, bi, count_stall=count_stall):
                return False
        return True

    def _spec_dispatch(self, runnable, drafts):
        """Dispatch stage of a verify step: score all K+1 window positions
        of every runnable lane in one pass, the target's argmax per row
        (`[slots, K+1]`) or under sampling `verify_window`'s (choices,
        accepts), and start their readback without waiting. Idle and
        stalled lanes ride (token 0, position 0, draft length 0, all-zero
        table). Returns the `_InFlight` record."""
        W = self.spec_decode_k + 1
        t_span = now_us()
        with self._phase("dispatch"):
            tokens = np.zeros((self.num_slots, W), np.int32)
            positions = np.zeros(self.num_slots, np.int32)
            dlens = np.zeros(self.num_slots, np.int32)
            tables = np.zeros((self.num_slots, self.max_blocks), np.int32)
            for i in runnable:
                slot = self._slots[i]
                d = drafts[i]
                tokens[i, 0] = slot.feed_token
                tokens[i, 1:1 + len(d)] = d
                positions[i] = slot.feed_pos
                dlens[i] = len(d)
                tables[i, :len(slot.blocks)] = slot.blocks
            kp, vp, sc = self._pools()
            with RecordEvent("engine.decode"), torch.no_grad():
                t_dec = time.perf_counter()
                toks, pos, dl = (self._put(a)
                                 for a in (tokens, positions, dlens))
                hidden = self.model.gpt.forward_verify_paged(
                    toks, pos, dl, kp, vp, self._put(tables), sc,
                    self.attention_backend, self._qweights,
                    self._lora(self._lane_slots(runnable)), tp=self._tp)
                logits = self.model._logits_of(hidden, self._tp)
                if self.sampling:
                    # rejection-sampling acceptance over the window:
                    # per-row coins and the residual or bonus draws
                    first = self._first_shard
                    out = verify_window(logits, first(toks), first(dl),
                                        *self._sampling_rows(self._slots),
                                        first(pos))
                else:
                    out = (logits.argmax(-1),)
                host, event = self._readback(out)
        self.decode_steps += 1
        self._step_seq += 1
        return _InFlight(out=tuple(out), runnable=runnable,
                         slots=[self._slots[i] for i in runnable],
                         drafts=drafts, host=host, event=event, t_dec=t_dec,
                         t_span=t_span, seq=self._step_seq)

    def _spec_complete(self, inflight, synced):
        """Complete stage of a verify step: the readback, then per lane
        the longest draft prefix the target confirms plus its own next
        token (exact acceptance: each draft token equal to the target's
        argmax at its position; under sampling the longest prefix whose
        coins passed, then the stop row's choice, which for greedy lanes
        is the same stream). Emission stops at the first EOS or at the
        request's budget. The walks and retirement stay on the step
        thread: they decide the next window's context, and a retired
        lane's blocks must not return to the allocator while a dispatched
        step can still write them."""
        K = self.spec_decode_k
        outs = self._host_tokens(inflight, synced)
        self._m_decode_seconds.observe(time.perf_counter() - inflight.t_dec)
        self._trace_span("decode.verify", inflight.t_span, cat="engine",
                         lanes=len(inflight.runnable), k=K)
        t_dec = inflight.t_dec
        now = time.perf_counter()
        with self._phase("finish"):
            for i, slot in zip(inflight.runnable, inflight.slots):
                req = slot.req
                d = inflight.drafts[i]
                if self.sampling:
                    choices, accepts = outs
                    with self._phase("sample_walk"):
                        n = 0
                        while n < len(d) and accepts[i, n]:
                            n += 1
                        acc = [int(t) for t in d[:n]] \
                            + [int(choices[i, n])]
                else:
                    with self._phase("accept_walk"):
                        out = outs[0][i]
                        acc = [int(out[0])]
                        for j, dj in enumerate(d):
                            if dj != int(out[j]):
                                break
                            acc.append(int(out[j + 1]))
                self.spec_accepted_tokens += len(acc) - 1
                self.spec_rejected_tokens += len(d) - (len(acc) - 1)
                self._m_spec_ok.inc(len(acc) - 1)
                self._m_spec_rej.inc(len(d) - (len(acc) - 1))
                emit = []
                for t in acc:
                    emit.append(t)
                    if (req.eos_token_id is not None
                            and t == req.eos_token_id) \
                            or len(slot.generated) + len(emit) \
                            >= req.max_new_tokens:
                        break
                m_tok = len(emit)
                is_first = not slot.generated  # a full-prefix-hit lane
                slot.generated.extend(emit)
                self._note_tokens(req, m_tok)
                self._m_spec_accepted.observe(m_tok)
                proposed = self._m_spec_ok.value + self._m_spec_rej.value
                if proposed:
                    self._m_spec_hit_rate.set(
                        self._m_spec_ok.value / proposed)
                if is_first:
                    if req.arrived_at is not None:
                        self._obs_ttft(req, now - req.arrived_at)
                    self.flight.record("first_token", req.req_id)
                    self._trace_instant("request.first_token", req)
                # every accepted token lands in TPOT against its producing
                # step: the lane's gap amortized over the window
                gap = now - (t_dec
                             if is_first or slot.last_token_at is None
                             else slot.last_token_at)
                n_tpot = m_tok - 1 if is_first else m_tok
                for _ in range(n_tpot):
                    self._obs_tpot(req, gap / m_tok)
                slot.last_token_at = now
                done_eos = req.eos_token_id is not None \
                    and emit[-1] == req.eos_token_id
                if done_eos or len(slot.generated) >= req.max_new_tokens:
                    if is_first and n_tpot == 0:
                        self._obs_tpot(req, now - t_dec)
                    self._finish(slot, "eos" if done_eos else "length")
                    self._slots[i] = None
        return len(inflight.runnable)

    def step(self):
        """One scheduler iteration: admit queued requests into free lanes,
        run at most one prefill chunk, then one batched decode step.
        Returns the number of admissions/chunks/lanes that progressed.
        With the async core the same stages run one step ahead
        (`_step_async`)."""
        if self.async_core:
            return self._step_async()
        with RecordEvent("engine.step"):
            t_wall = time.perf_counter()
            if self.chunked_prefill:
                progressed = self._admit_chunked()
                progressed += self._prefill_step()
            else:
                progressed = self._admit()
            progressed += self._decode_step()
            self._flush_step_phases(time.perf_counter() - t_wall)
            self._end_of_step_gauges()
            return progressed

    # -- async core (dispatch-ahead pipeline) --------------------------------
    def _step_async(self):
        """One pipelined scheduler iteration, JAX's `_step_async`:

        1. complete step N, the one the previous call dispatched: wait on
           its event (`device_wait`, the pipeline's only wait), then the
           walks and retirement on this thread;
        2. spawn the drafter helper over snapshots of every decode lane's
           context;
        3. admit and run one prefill chunk while it proposes;
        4. schedule and dispatch step N+1 with the helper's drafts, its
           rows from pinned staging, its readback started; it stays in
           flight for the next call;
        5. prefetch the queue head's adapter page behind it.

        `progressed` counts admissions, prefill chunks and COMPLETED
        decode lanes, so run totals match the serial core and `run()`'s
        deadlock check stays sound."""
        with RecordEvent("engine.step"):
            t_wall = time.perf_counter()
            progressed = self._complete_inflight()
            self._spawn_ahead()
            if self.chunked_prefill:
                progressed += self._admit_chunked()
                progressed += self._prefill_step()
            else:
                progressed += self._admit()
            self._next_drafts = self._collect_ahead()
            self._dispatch_ahead()
            self._next_drafts = {}
            self._prefetch_ahead()
            self._flush_step_phases(time.perf_counter() - t_wall)
            self._end_of_step_gauges()
            return progressed

    def _complete_inflight(self):
        """Retire the step dispatched ahead, if one is outstanding: wait
        for its event, then run the complete stage on this thread."""
        inflight = self._inflight
        if inflight is None:
            return 0
        self._inflight = None
        with self._phase("device_wait"):
            # the pipeline's only wait: the host stages since the dispatch
            # already ran behind the device step
            if inflight.event is not None:
                inflight.event.synchronize()
        self.flight.record("async_complete", seq=inflight.seq,
                           lanes=len(inflight.runnable))
        if self.spec_decode_k:
            return self._spec_complete(inflight, synced=True)
        return self._plain_complete(inflight, synced=True)

    def _dispatch_ahead(self):
        """Schedule and dispatch the next decode or verify step into the
        in-flight slot, without a wait; the next `step()` (or `drain`)
        completes it."""
        if self.spec_decode_k:
            runnable, drafts = self._spec_schedule()
            if not runnable:
                return
            self._inflight = self._spec_dispatch(runnable, drafts)
        else:
            runnable = self._plain_schedule()
            if not runnable:
                return
            self._inflight = self._plain_dispatch(runnable)
        self.flight.record("async_dispatch", seq=self._inflight.seq,
                           lanes=len(runnable))

    def _spawn_ahead(self):
        """Start the drafter helper thread: every decode lane's next
        window proposed off the step thread while admissions and the
        prefill chunk run, over a snapshot of `generated` (the live list
        grows when lanes advance) through `draft_window`, under the
        step thread's torch state (`draft_thread_state`). Its
        `draft_propose` time lands on its own thread's phase clock, never
        in the step's."""
        if not self.spec_decode_k or self.drafter is None:
            return
        K = self.spec_decode_k
        vocab = self.model.config.vocab_size
        jobs = []
        for slot in self._slots:
            if slot is None or slot.prefilling:
                continue
            budget = min(K, slot.req.max_new_tokens - len(slot.generated) - 1,
                         self.max_model_len - 1 - slot.feed_pos)
            if budget > 0:
                jobs.append((slot, slot.req.prompt, list(slot.generated),
                             budget))
        if not jobs:
            return
        out = {}
        phases = self._phases
        drafter = self.drafter
        state = draft_thread_state(drafter)

        def work():
            with state():
                for slot, prompt, generated, budget in jobs:
                    with phases.phase("draft_propose"):
                        out[slot] = draft_window(drafter, prompt, generated,
                                                 budget, vocab)

        t = threading.Thread(target=work, name="paddle-draft-ahead",
                             daemon=True)
        t.start()
        self._ahead = (t, out)

    def _collect_ahead(self):
        """Join the drafter helper; only the step thread's residual wait
        lands in its own `draft_propose` phase."""
        ahead = self._ahead
        if ahead is None:
            return {}
        self._ahead = None
        t, out = ahead
        with self._phase("draft_propose"):
            t.join()
        return out

    def _prefetch_ahead(self):
        """Warm the next admission's adapter page behind the step just
        dispatched: the page copy, from pinned staging without a wait,
        overlaps that step on the device, and a prefetch never takes a
        reference or evicts a live page, so the next call's
        `_acquire_adapter` finds it resident."""
        if self.adapter_pool is None:
            return
        req = self._peek_request()
        if req is None or not req.adapter_id \
                or not self.adapter_pool.registry.has(req.adapter_id):
            return
        if self.adapter_pool.page_of(req.adapter_id) is not None:
            return                     # already resident (warm or live)
        page = self.adapter_pool.prefetch(req.adapter_id,
                                          non_blocking=self._staged)
        if page is not None:
            self.flight.record("adapter_prefetch", req.req_id,
                               adapter=int(req.adapter_id), page=page)
            self._update_adapter_gauges()

    @property
    def num_active(self):
        return sum(s is not None for s in self._slots)

    @property
    def num_pending(self):
        return sum(len(self._queues[p]) for p in PRIORITY_CLASSES)

    def best_of_n(self, prompt, n, max_new_tokens, sampling_params=None,
                  eos_token_id=None, priority="standard", adapter_id=0):
        """Fan ONE prompt into `n` sampled candidates sharing its
        prefix-cache blocks: candidate 0 is served first (its prefill
        writes and registers the prompt's full blocks once), then
        candidates 1..n-1 admit with a full-prefix hit, the shared blocks
        seated read-only (copy-on-write keeps decode writes private).
        Candidate i samples under seed `base + i` (base from
        `sampling_params.seed`, or the engine counter when None), so a
        fixed base replays all n candidates token for token; all of them
        under `adapter_id`. Drives `run()`; other queued work is served
        along the way and its finishes stay collectable. Returns the n
        candidate token lists (prompt + generated), in seed order."""
        params, base, self._seed_counter = _best_of_n_intake(
            self, sampling_params, n, self._seed_counter)
        out, stash = _best_of_n_fanout(
            lambda p: self.add_request(
                prompt, max_new_tokens, eos_token_id=eos_token_id,
                priority=priority, sampling_params=p, adapter_id=adapter_id),
            self.run, params, n, base)
        self._results.update(stash)
        return out

    def pop_results(self):
        """{req_id: tokens} finished since the last pop (None = shed)."""
        out, self._results = self._results, {}
        return out

    def drain(self):
        """Close admissions, run every queued and live request to the end
        (the async core's step in flight included: its lanes are live
        until it completes), then audit the pools: every non-null block
        must be free or a refcount-zero cached block, and every non-null
        adapter page free or parked warm, no rank group holding two. A
        failed audit carries the flight recorder's history. Returns
        run()'s results."""
        self._draining = True
        out = self.run()
        leaked = self.cache.leak_check()
        if leaked:
            raise self._audit_error(
                f"drain leak check failed: block(s) {leaked} neither "
                "free nor prefix-cached after all lanes finished")
        if self.adapter_pool is not None:
            leaked = self.adapter_pool.leak_check()
            if leaked:
                raise self._audit_error(
                    f"drain leak check failed: adapter page(s) {leaked} "
                    "still referenced after all lanes finished — a "
                    "scheduler path vacated a lane without releasing its "
                    "adapter page")
        self._end_of_step_gauges()
        return out

    def run(self):
        """Drive until every queued/admitted request finished; returns (and
        clears) {req_id: prompt + generated tokens; None if shed}."""
        while self.num_pending or self.num_active:
            if self.step() == 0:
                stalled = sum(s is not None and s.prefilling
                              for s in self._slots)
                raise RuntimeError(
                    "generation engine deadlocked: "
                    f"{stalled} lane(s) stalled in prefill and "
                    f"{self.num_active - stalled} in decode growth/"
                    "copy-on-write, all waiting on a block, with "
                    f"{self.cache.num_free} free blocks — grow num_blocks "
                    "or shrink num_slots/max_model_len")
        return self.pop_results()
