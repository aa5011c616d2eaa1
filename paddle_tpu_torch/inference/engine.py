"""Continuous-batching generation engine over a paged KV cache: counterpart
of paddle_tpu/inference/engine.py (greedy, fp or int8 pools, speculative
decoding, one device, serial core).

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
- the attention backend (`attention_backend`, or the environment's
  `PADDLE_PAGED_ATTENTION_BACKEND`, which wins): `auto`/`dense`/`pallas`
  resolved once by `ops.paged_attention.resolve_backend`; `pallas` runs
  the paged kernels, `dense` their plain versions on every device.

The pools (and scales) are updated IN PLACE by every step (PyTorch is
eager: there is no compiled step, no donation, no trace count). Greedy
output matches `GPTForCausalLM.generate(use_cache=True)` per request, with
or without speculation; int8 pools hold to the JAX int8 engine instead.

Left for later slices: bucketed prefill, sampled acceptance and the async
drafter thread, tensor parallelism, int8 weights, adapters, sampling, the
environment overrides (`PADDLE_SPEC_DECODE_K`, `PADDLE_SERVE_KV_DTYPE`),
the metrics registry, tracing and the flight recorder, the async core and
the fleet handoff. Plain counters stand in for the metrics.
"""
from __future__ import annotations

import hashlib
import math
import os
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..ops.paged_attention import (KV_QUANT_EPS, copy_pool_block,
                                   resolve_backend)
from .speculative import NgramDrafter, draft_window

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
    None."""

    def __init__(self, num_layers, num_blocks, block_size, num_heads,
                 head_dim, dtype=torch.float32, device=None, kv_dtype=None):
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
        self.device = resolve_device(device)
        shape, dt = self.pool_spec()
        self.kpool = torch.zeros(shape, dtype=dt, device=self.device)
        self.vpool = torch.zeros(shape, dtype=dt, device=self.device)
        self.scales = None
        if kv_dtype == "int8":
            shape, dt = self.scale_spec()
            self.scales = torch.full(shape, KV_QUANT_EPS, dtype=dt,
                                     device=self.device)
        # LIFO free list: recently-freed blocks are reused first
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._ref = [0] * self.num_blocks
        self._ref[0] = 1               # null block: permanently held
        self._block_of = {}            # chain hash -> cached block id
        self._hash_of = {}             # cached block id -> chain hash
        self._evictable = OrderedDict()   # refcount-0 cached, oldest first

    def pool_spec(self):
        """`([layers, blocks, block_size, heads, head_dim], dtype)`: int8
        under `kv_dtype="int8"`."""
        dt = torch.int8 if self.kv_dtype == "int8" else self.dtype
        return ((self.num_layers, self.num_blocks, self.block_size,
                 self.num_heads, self.head_dim), dt)

    def scale_spec(self):
        """`([layers, blocks, 2], float32)` for int8 pools, else None."""
        if self.kv_dtype != "int8":
            return None
        return ((self.num_layers, self.num_blocks, 2), torch.float32)

    def pool_nbytes(self):
        """Bytes of the paged KV state: both pools plus the scales."""
        n = sum(t.numel() * t.element_size()
                for t in (self.kpool, self.vpool))
        if self.scales is not None:
            n += self.scales.numel() * self.scales.element_size()
        return n

    @property
    def num_free(self):
        """Blocks allocatable now: truly free + evictable cached."""
        return len(self._free) + len(self._evictable)

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
        for b in got:
            self._ref[b] = 1
        if got and self.scales is not None:
            # a recycled block's grid belongs to its previous tenant: reset
            # it to the floor so the new owner's first write sets a fresh
            # grid
            self.scales[:, got] = KV_QUANT_EPS
        return got

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

    def match_prefix(self, tokens):
        """Longest cached block-aligned prefix of `tokens`: takes a
        reference on every hit (reviving evictable ones) and returns
        (blocks, hit_tokens)."""
        blocks = []
        for h in iter_prefix_key(tokens, self.block_size):
            b = self._block_of.get(h)
            if b is None:
                break
            if self._ref[b] == 0:
                del self._evictable[b]     # revive: live again
            self._ref[b] += 1
            blocks.append(b)
        return blocks, len(blocks) * self.block_size

    def warm_prefix_tokens(self, tokens):
        """Prompt tokens a `match_prefix` would serve right now: a
        read-only peek (no references taken)."""
        hit = 0
        for h in iter_prefix_key(tokens, self.block_size):
            if h not in self._block_of:
                break
            hit += self.block_size
        return hit

    def register_prefix(self, tokens, blocks):
        """Publish a fully prefilled prompt's FULL blocks (first writer
        wins). Returns the number of blocks newly cached."""
        added = 0
        for h, blk in zip(iter_prefix_key(tokens, self.block_size), blocks):
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
    priority: str = "standard"         # one of PRIORITY_CLASSES


@dataclass(eq=False)
class _Slot:
    """A live decode lane: the request plus its paged-cache footprint."""

    req: Request
    blocks: list                       # owned/shared pool block ids
    generated: list = field(default_factory=list)
    prefill_pos: int = 0               # next prompt position to prefill
    admit_seq: int = 0                 # admission order tiebreak

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
    `attention_backend` (`auto` by default) is resolved once into
    `attention_backend` (`dense` or `pallas`); `auto` is dense at head dims
    and block sizes the kernels do not take. Counters: `tokens_generated`,
    `prefix_hit_tokens`, `cow_copies`, `prefill_chunks`, `decode_steps`
    (verify steps when K > 0), `stalls` by path (`prefill`, `decode`, and
    `spec_degrade`: a lane that shed its draft under pool pressure and
    still ran), `shed`, `spec_accepted_tokens` and `spec_rejected_tokens`.
    """

    def __init__(self, model, num_slots=8, block_size=16, num_blocks=None,
                 max_model_len=None, eos_token_id=None, prefill_chunk=None,
                 enable_prefix_cache=True, max_queue=None, device=None,
                 spec_decode_k=0, drafter=None, kv_dtype=None,
                 attention_backend=None):
        cfg = model.config
        if model.training and cfg.dropout > 0:
            raise ValueError("GenerationEngine decodes deterministically "
                             "(no dropout) — call model.eval() first")
        self.device = resolve_device(device)
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
        self.prefill_chunk = max(1, min(
            int(prefill_chunk or 128), self.max_model_len))
        self.enable_prefix_cache = bool(enable_prefix_cache)
        k = int(spec_decode_k)
        if k < 0:
            raise ValueError(f"spec_decode_k must be >= 0, got {k}")
        self.spec_decode_k = k
        self.drafter = (drafter if drafter is not None else NgramDrafter()) \
            if k > 0 else None
        # default pool: every slot at full context (+ the null block)
        self.cache = PagedKVCache(
            cfg.num_layers,
            int(num_blocks or 1 + self.num_slots * self.max_blocks),
            self.block_size, cfg.num_heads,
            cfg.hidden_size // cfg.num_heads, dtype=wte.dtype,
            device=self.device, kv_dtype=kv_dtype)
        self._queues = {p: deque() for p in PRIORITY_CLASSES}
        self._slots = [None] * self.num_slots
        self._results = {}
        self._draining = False
        self._auto_id = 0
        self._admit_counter = 0
        self.tokens_generated = 0
        self.prefix_hit_tokens = 0
        self.cow_copies = 0
        self.prefill_chunks = 0
        self.decode_steps = 0
        self.stalls = {"prefill": 0, "decode": 0, "spec_degrade": 0}
        self.shed = 0
        self.spec_accepted_tokens = 0
        self.spec_rejected_tokens = 0

    # -- request intake ----------------------------------------------------
    def add_request(self, prompt, max_new_tokens, eos_token_id=None,
                    req_id=None, priority="standard"):
        """Queue a request; it is admitted into a free lane between steps
        (may be called while `run`/`step` is mid-stream). With `max_queue`
        set and the queue full, the lowest-priority loser is shed: its
        result is None. Returns the request id."""
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
        req = Request(req_id, prompt, int(max_new_tokens), eos,
                      priority=priority)
        if self.max_queue is not None \
                and self.num_pending >= self.max_queue:
            victim = self._shed_victim(priority)
            if victim is None:         # incoming ranks no better: shed it
                self._shed(req)
                return req_id
            self._shed(victim)
        self._queues[priority].append(req)
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

    def _in_flight(self):
        ids = {r.req_id for p in PRIORITY_CLASSES for r in self._queues[p]}
        ids.update(s.req.req_id for s in self._slots if s is not None)
        ids.update(self._results)
        return ids

    def _pop_request(self):
        for p in PRIORITY_CLASSES:
            if self._queues[p]:
                return self._queues[p].popleft()
        return None

    # -- scheduler ---------------------------------------------------------
    def _finish(self, i):
        slot = self._slots[i]
        self._results[slot.req.req_id] = \
            list(map(int, slot.req.prompt)) + slot.generated
        self.cache.free(slot.blocks)
        self._slots[i] = None

    def _emit(self, i, toks):
        """Append generated tokens to lane i up to and including the first
        EOS or the request's budget; retire the lane if either was hit."""
        slot = self._slots[i]
        req = slot.req
        for tok in toks:
            slot.generated.append(tok)
            self.tokens_generated += 1
            if (req.eos_token_id is not None and tok == req.eos_token_id) \
                    or len(slot.generated) >= req.max_new_tokens:
                self._finish(i)
                return

    def _admit_chunked(self):
        """Seat queued requests into free lanes: match the longest cached
        block-aligned prefix (read-only references) and leave the tail to
        the chunked prefill. A full-prefix hit enters decode directly."""
        admitted = 0
        while None in self._slots:
            req = self._pop_request()
            if req is None:
                break
            blocks, hit = [], 0
            if self.enable_prefix_cache:
                blocks, hit = self.cache.match_prefix(req.prompt)
                self.prefix_hit_tokens += hit
            slot = _Slot(req=req, blocks=list(blocks), prefill_pos=hit,
                         admit_seq=self._admit_counter)
            self._admit_counter += 1
            self._slots[self._slots.index(None)] = slot
            admitted += 1
        return admitted

    def _device_int32(self, arr):
        return torch.from_numpy(arr).to(self.device)

    def _prefill_step(self):
        """Run at most ONE prefill chunk: the neediest prefilling lane
        (priority, then admission order) allocates the chunk's blocks and
        pushes `prefill_chunk` prompt positions through the model; the
        final chunk yields the first generated token. A lane that cannot
        get blocks stalls and the next candidate gets the chunk."""
        cands = sorted(
            (i for i, s in enumerate(self._slots)
             if s is not None and s.prefilling),
            key=lambda i: (PRIORITY_CLASSES.index(
                self._slots[i].req.priority), self._slots[i].admit_seq))
        C = self.prefill_chunk
        for i in cands:
            slot = self._slots[i]
            req = slot.req
            plen = int(req.prompt.size)
            start = slot.prefill_pos
            end = min(start + C, plen)
            need = math.ceil(end / self.block_size) - len(slot.blocks)
            if need > 0:
                got = self.cache.allocate(need)
                if got is None:
                    self.stalls["prefill"] += 1
                    continue           # pool pressure: next candidate
                slot.blocks.extend(got)
            tokens = np.zeros((1, C), np.int32)
            tokens[0, :end - start] = req.prompt[start:end]
            row = np.zeros(self.max_blocks, np.int32)
            row[:len(slot.blocks)] = slot.blocks
            c = self.cache
            with torch.no_grad():
                hidden = self.model.gpt.forward_prefill_chunk(
                    self._device_int32(tokens), start, c.kpool, c.vpool,
                    self._device_int32(row), plen, c.scales)
                self.prefill_chunks += 1
                slot.prefill_pos = end
                if end < plen:
                    return 1
                # the last real prompt position's logits: first token
                logits = self.model._logits_of(hidden[0, plen - 1 - start])
                first = int(logits.argmax(-1))
            if self.enable_prefix_cache:
                # the prompt's KV is fully written: publish its full blocks
                self.cache.register_prefix(req.prompt, slot.blocks)
            self._emit(i, [first])
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
                self.stalls["decode"] += 1
            return False
        src, dst = slot.blocks[bi], got[0]
        # int8 pools: the block's grid rides the copy
        copy_pool_block(self.cache.kpool, self.cache.vpool, src, dst,
                        self.cache.scales)
        self.cache.free([src])         # drop our shared reference
        slot.blocks[bi] = dst
        self.cow_copies += 1
        return True

    def _plain_schedule(self):
        """On-demand block growth + copy-on-write per decode-phase lane;
        returns the runnable lane indices."""
        runnable = []
        for i, slot in enumerate(self._slots):
            if slot is None or slot.prefilling:
                continue
            bi = slot.feed_pos // self.block_size
            if bi >= len(slot.blocks):
                got = self.cache.allocate(1)
                if got is None:
                    self.stalls["decode"] += 1
                    continue           # stalled this iteration
                slot.blocks.extend(got)
            elif self.cache.needs_cow(slot.blocks[bi]):
                if not self._cow_promote(slot, bi):
                    continue
            runnable.append(i)
        return runnable

    def _decode_step(self):
        """One batched decode step over the runnable lanes. Idle and
        stalled lanes ride token 0, position 0 and an all-zero table: they
        write the null block and their tokens are discarded. With K > 0
        the step is the speculative verify step."""
        if self.spec_decode_k:
            runnable, drafts = self._spec_schedule()
            if not runnable:
                return 0
            return self._spec_complete(runnable, drafts,
                                       self._spec_dispatch(runnable, drafts))
        runnable = self._plain_schedule()
        if not runnable:
            return 0
        tokens = np.zeros((self.num_slots, 1), np.int32)
        positions = np.zeros(self.num_slots, np.int32)
        tables = np.zeros((self.num_slots, self.max_blocks), np.int32)
        for i in runnable:
            slot = self._slots[i]
            tokens[i, 0] = slot.feed_token
            positions[i] = slot.feed_pos
            tables[i, :len(slot.blocks)] = slot.blocks
        c = self.cache
        with torch.no_grad():
            hidden = self.model.gpt.forward_decode_paged(
                self._device_int32(tokens), self._device_int32(positions),
                c.kpool, c.vpool, self._device_int32(tables), c.scales,
                self.attention_backend)
            nxt = self.model._logits_of(hidden)[:, 0].argmax(-1).cpu() \
                .numpy()
        self.decode_steps += 1
        for i in runnable:
            self._emit(i, [int(nxt[i])])
        return len(runnable)

    def _spec_schedule(self):
        """Schedule stage of a verify step: draft up to K tokens per
        decode-phase lane (host-side), then grow the table to the window's
        last write and copy-on-write every block the window writes. Under
        pool pressure a lane sheds its draft (a `spec_degrade` stall: it
        still runs a one-token window) before it stalls; when the COW copy
        fails mid-window it also returns the surplus tail blocks past its
        feed block, which only ever held rejected rows. Returns (runnable
        lane indices, lane -> draft)."""
        K = self.spec_decode_k
        bs = self.block_size
        vocab = self.model.config.vocab_size
        runnable, drafts = [], {}
        for i, slot in enumerate(self._slots):
            if slot is None or slot.prefilling:
                continue
            req = slot.req
            # emitted tokens cap at the request's allowance, and the last
            # write position stays inside the model's length
            budget = min(K, req.max_new_tokens - len(slot.generated) - 1,
                         self.max_model_len - 1 - slot.feed_pos)
            draft = draft_window(self.drafter, req.prompt, slot.generated,
                                 budget, vocab)
            stalled = False
            while True:
                need = (slot.feed_pos + len(draft)) // bs + 1 \
                    - len(slot.blocks)
                if need <= 0:
                    break
                got = self.cache.allocate(need)
                if got is not None:
                    slot.blocks.extend(got)
                    break
                if not draft:
                    self.stalls["decode"] += 1
                    stalled = True
                    break
                draft = []             # degrade: draftless step
                self.stalls["spec_degrade"] += 1
            if stalled:
                continue
            if not self._cow_window(slot, len(draft), count_stall=False):
                feed_bi = slot.feed_pos // bs
                surplus = slot.blocks[feed_bi + 1:]
                if surplus:
                    del slot.blocks[feed_bi + 1:]
                    self.cache.free(surplus)
                if draft:
                    draft = []
                    self.stalls["spec_degrade"] += 1
                if not self._cow_window(slot, 0, count_stall=True):
                    continue           # truly stalled this iteration
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
        """Score all K+1 window positions of every runnable lane in one
        verify pass; returns the target's argmax per row, `[slots, K+1]`.
        Idle and stalled lanes ride (token 0, position 0, draft length 0,
        all-zero table)."""
        W = self.spec_decode_k + 1
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
        c = self.cache
        with torch.no_grad():
            hidden = self.model.gpt.forward_verify_paged(
                self._device_int32(tokens), self._device_int32(positions),
                self._device_int32(dlens), c.kpool, c.vpool,
                self._device_int32(tables), c.scales, self.attention_backend)
            nxt = self.model._logits_of(hidden).argmax(-1).cpu().numpy()
        self.decode_steps += 1
        return nxt

    def _spec_complete(self, runnable, drafts, nxt):
        """Exact greedy acceptance per lane: the target's own next token,
        then every draft token that equals the target's argmax at its
        position (each match validates the next column); emission stops at
        the first EOS or at the request's budget."""
        for i in runnable:
            d = drafts[i]
            out = nxt[i]
            acc = [int(out[0])]
            for j, dj in enumerate(d):
                if dj != int(out[j]):
                    break
                acc.append(int(out[j + 1]))
            self.spec_accepted_tokens += len(acc) - 1
            self.spec_rejected_tokens += len(d) - (len(acc) - 1)
            self._emit(i, acc)
        return len(runnable)

    def step(self):
        """One scheduler iteration: admit queued requests into free lanes,
        run at most one prefill chunk, then one batched decode step.
        Returns the number of admissions/chunks/lanes that progressed."""
        progressed = self._admit_chunked()
        progressed += self._prefill_step()
        progressed += self._decode_step()
        return progressed

    @property
    def num_active(self):
        return sum(s is not None for s in self._slots)

    @property
    def num_pending(self):
        return sum(len(self._queues[p]) for p in PRIORITY_CLASSES)

    def pop_results(self):
        """{req_id: tokens} finished since the last pop (None = shed)."""
        out, self._results = self._results, {}
        return out

    def drain(self):
        """Close admissions, run every queued and live request to the end,
        then audit the pool: every non-null block must be free or a
        refcount-zero cached block. Returns run()'s results."""
        self._draining = True
        out = self.run()
        leaked = self.cache.leak_check()
        if leaked:
            raise RuntimeError(
                f"drain leak check failed: block(s) {leaked} neither "
                "free nor prefix-cached after all lanes finished")
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
