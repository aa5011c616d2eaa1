"""Paged adapter pool, the DEVICE half of the multi-tenant adapter
subsystem: counterpart of paddle_tpu/adapters/pool.py on one device.

The paged KV cache's design applied to adapter weights: a fixed number of
device-resident PAGES per target site (`adapter_pool_spec` is the single
layout truth), a host-side refcount per page, an LRU of refcount-zero
(warm but idle) pages, and stall-and-retry under pressure: `acquire`
returns None when every page is referenced, and the engine retries the
admission later, as after a KV block stall. Page 0 is the null page:
permanently held, all-zero factors, zero scaling; adapter id 0 resolves
there and its delta is exactly zero.

Swap-in is host-driven: on an `acquire` miss the pool copies the
registry's rank-padded stacks onto a free (or LRU-evicted) page, IN PLACE,
cast to the pool's dtype (the JAX package writes the page with a donated
`dynamic_update_index_in_dim`). The serving steps only read the pool
tensors, so a swap-in between steps changes nothing else. Rank rows past
an adapter's rank stay exact zeros.

Under tensor parallel (`mesh=`, a `distributed.ServingMesh`) the B stacks
shard their OUTPUT layout over the mesh (`shard_axis` in the spec: `b_qkv`
on its heads axis, the engine's qkv grouping, and the linear sites on
their column axis), one contiguous tensor a shard on its device, while the
A stacks and the scalings are replicated, one tensor a distinct device.
Each shard computes exactly its own slice of every delta with full-length
dots, so the batched LoRA at mp=N adds no collective. A swap-in writes
each shard's slice.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.topology import check_mp_axis
from .registry import NULL_ADAPTER_ID, AdapterRegistry

__all__ = ["PagedAdapterPool", "adapter_pool_spec"]

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.float64): torch.float64}


def _torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name
    (bfloat16 by its name: numpy has none of its own)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return _NP_TO_TORCH[np.dtype(dtype)]


def adapter_pool_spec(num_pages, num_layers, max_rank, hidden_size,
                      intermediate_size, num_heads, dtype):
    """The ONE source of truth for the pool's per-site layout, JAX's
    shapes and order: ordered {name: (shape, dtype, shard_axis)}, where
    `shard_axis` is the axis a tensor-parallel mesh would shard (None =
    replicated). The order is `ops.lora.LoraState`'s constructor order.
    `dtype` is the factors' (a torch or numpy dtype), `scaling` f32."""
    P, L, R = int(num_pages), int(num_layers), int(max_rank)
    H, I = int(hidden_size), int(intermediate_size)
    heads = int(num_heads)
    D = H // heads
    dt = _torch_dtype(dtype)
    return OrderedDict([
        ("a_qkv", ((P, L, R, H), dt, None)),
        ("b_qkv", ((P, L, R, heads, 3, D), dt, 3)),
        ("a_out", ((P, L, R, H), dt, None)),
        ("b_out", ((P, L, R, H), dt, 3)),
        ("a_fc1", ((P, L, R, H), dt, None)),
        ("b_fc1", ((P, L, R, I), dt, 3)),
        ("a_fc2", ((P, L, R, I), dt, None)),
        ("b_fc2", ((P, L, R, H), dt, 3)),
        ("scaling", ((P,), torch.float32, None)),
    ])


class PagedAdapterPool:
    """Device-resident pages of active adapters + host-side paging.

        reg = AdapterRegistry(model.config, max_rank=8)
        pool = PagedAdapterPool(reg, num_pages=9, device="cuda")
        page = pool.acquire(7)       # swap-in on miss; None = stall
        ...
        pool.release(7)              # refcount down; warm LRU at zero

    `num_pages` INCLUDES the null page 0. The engine sizes its default pool
    at `1 + num_slots`, so a full batch of distinct tenants never stalls;
    smaller pools trade device memory for swap-in traffic and ride the
    stall/retry path under pressure. `dtype` is the factors' (the
    registry's when None); `device=None` means the CUDA card. With `mesh`
    the pool lives on the mesh's devices (its first is `device`) and
    `arrays(shard)` gives each shard's tensors.

    The parameters are JAX's, in JAX's order; `device` is the port's own,
    keyword-only. `mp_axis` must be `'mp'` (the serving mesh's one axis).
    `donate` is stored and without effect: JAX donates the page arrays to
    its compiled swap-in, and here the swap-in writes the page in place."""

    def __init__(self, registry, num_pages=None, dtype=None, mesh=None,
                 mp_axis="mp", donate=None, *, device=None):
        check_mp_axis(mp_axis)
        self._donate = donate
        if not isinstance(registry, AdapterRegistry):
            raise TypeError(
                "PagedAdapterPool takes an AdapterRegistry (the "
                "host-side store it swaps adapters in from)")
        if num_pages is None:
            num_pages = 1 + max(1, len(registry))
        if num_pages < 2:
            raise ValueError("need >= 2 adapter pages (page 0 is the "
                             "null adapter)")
        self.registry = registry
        self.num_pages = int(num_pages)
        self.max_rank = registry.max_rank
        self.dtype = _torch_dtype(dtype if dtype is not None
                                  else registry.dtype)
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            mp = mesh.shape["mp"]
            for name, dim in (("num_heads", registry.num_heads),
                              ("hidden_size", registry.hidden_size),
                              ("intermediate_size",
                               registry.intermediate_size)):
                if dim % mp:
                    raise ValueError(
                        f"{name}={dim} not divisible by mp degree "
                        f"{mp} — cannot column-shard the adapter B "
                        "pages")
            self.device = mesh.devices[0]
            if device is not None and \
                    torch.device(device).type != self.device.type:
                raise ValueError(f"device {device!r} is not the mesh's "
                                 f"{self.device}")
        self._spec = adapter_pool_spec(
            self.num_pages, registry.num_layers, registry.max_rank,
            registry.hidden_size, registry.intermediate_size,
            registry.num_heads, self.dtype)
        self._shards = self._build_arrays()
        # paging state: the PagedKVCache's, page-sized
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._ref = [0] * self.num_pages
        self._ref[0] = 1               # null page: permanently held
        self._page_of = {}             # adapter id -> page
        self._adapter_of = {}          # page -> adapter id
        self._evictable = OrderedDict()    # page -> adapter id (LRU)
        self.swapins = 0
        self.evictions = 0
        # the ONE engine this pool pages for (set when an engine adopts
        # it): refcounts and the LRU are per engine
        self._owner = None

    # -- layout -----------------------------------------------------------
    def adapter_pool_spec(self):
        """This pool's `adapter_pool_spec` layout table."""
        return self._spec

    def _build_arrays(self):
        """Each shard's tensors in spec order: a sharded B stack's slice
        of `shard_axis` on the shard's device, a replicated tensor once a
        distinct device (one shard without a mesh)."""
        devices = (self.device,) if self.mesh is None else self.mesh.devices
        mp = len(devices)
        shards = [[] for _ in devices]
        for shape, dt, axis in self._spec.values():
            if axis is None or mp == 1:
                rep = {d: torch.zeros(shape, dtype=dt, device=d)
                       for d in dict.fromkeys(devices)}
                for r, d in enumerate(devices):
                    shards[r].append(rep[d])
                continue
            part = list(shape)
            part[axis] //= mp
            for r, d in enumerate(devices):
                shards[r].append(torch.zeros(part, dtype=dt, device=d))
        return [tuple(a) for a in shards]

    def arrays(self, shard=0):
        """The pool tensors in `LoraState` order (shard `shard`'s under a
        mesh)."""
        return self._shards[shard]

    def pool_nbytes(self):
        """Bytes the pool holds on its devices, every shard's."""
        held = {id(a): a for arrs in self._shards for a in arrs}
        return sum(a.numel() * a.element_size() for a in held.values())

    # -- swap-in ----------------------------------------------------------
    def _write_page(self, page, stacks, scaling, non_blocking=False):
        """Copy one adapter's host stacks onto `page`, IN PLACE, cast to
        the pool's dtype. `non_blocking` stages the rows in pinned host
        memory and copies them without a wait (the async core's prefetch:
        a copy from pageable memory would wait on the step in flight); the
        page's bytes are the same."""
        mp = len(self._shards)

        def put(arr, rows):
            src = torch.from_numpy(rows)
            if non_blocking and arr.device.type == "cuda":
                arr.copy_(src.pin_memory(), non_blocking=True)
            else:
                arr.copy_(src)
        for i, (name, (shape, _, axis)) in enumerate(self._spec.items()):
            held = [arrs[i] for arrs in self._shards]
            if name == "scaling":
                # a fill: assigning a Python scalar to one element copies
                # it from the host, which waits on the stream
                for arr in {id(a): a for a in held}.values():
                    arr[page].fill_(float(np.float32(scaling)))
                continue
            rows = np.ascontiguousarray(stacks[name])
            if rows.shape != shape[1:]:
                raise ValueError(
                    f"adapter stack {name} has shape {rows.shape}, pool "
                    f"page wants {shape[1:]}")
            if axis is None or mp == 1:
                for arr in {id(a): a for a in held}.values():
                    put(arr[page], rows)
                continue
            parts = np.split(rows, mp, axis=axis - 1)
            for arr, part in zip(held, parts):
                put(arr[page], np.ascontiguousarray(part))

    # -- paging -----------------------------------------------------------
    @property
    def num_free(self):
        """Pages acquirable right now: truly free + warm evictable."""
        return len(self._free) + len(self._evictable)

    @property
    def num_resident(self):
        """Adapters currently materialized on a page (live + warm)."""
        return len(self._page_of)

    def refcount(self, page):
        return self._ref[page]

    def page_of(self, adapter_id):
        """The page an adapter currently occupies (0 for the null
        adapter, None when not resident)."""
        aid = int(adapter_id)
        if aid == NULL_ADAPTER_ID:
            return 0
        return self._page_of.get(aid)

    def _group_sibling_page(self, aid):
        """The page a RANK-GROUP sibling of `aid` currently occupies (None
        when ungrouped or no sibling is resident): a rank group shares ONE
        page budget."""
        group = self.registry.group_of(aid)
        if group is None:
            return None
        for sib in self.registry.group_ids(group):
            if sib != aid:
                page = self._page_of.get(sib)
                if page is not None:
                    return page
        return None

    def can_acquire(self, adapter_id):
        """True when `acquire` would succeed right now (resident, a page
        is free or evictable, or the rank group's shared page sits
        idle)."""
        aid = int(adapter_id)
        if aid == NULL_ADAPTER_ID or aid in self._page_of:
            return True
        sib_page = self._group_sibling_page(aid)
        if sib_page is not None:
            return self._ref[sib_page] == 0
        return self.num_free > 0

    def acquire(self, adapter_id, non_blocking=False):
        """One reference on the adapter's page, swapping it in from the
        registry on a miss. Returns the page id, or None when every page
        is referenced by a live lane (the caller stalls and retries).
        Unknown ids raise. A miss whose rank-group sibling is resident and
        idle evicts the sibling and reuses its page in place (an eviction
        and a swap-in); a miss whose sibling is referenced stalls.
        `non_blocking` as in `_write_page`."""
        aid = int(adapter_id)
        if aid == NULL_ADAPTER_ID:
            return 0
        entry = self.registry.stacks(aid)      # raises when unknown
        page = self._page_of.get(aid)
        if page is not None:
            if self._ref[page] == 0:
                del self._evictable[page]      # revive: live again
            self._ref[page] += 1
            return page
        sib_page = self._group_sibling_page(aid)
        if sib_page is not None:
            if self._ref[sib_page] > 0:
                return None        # group budget busy: stall/retry
            page = sib_page
            del self._evictable[page]
            del self._page_of[self._adapter_of[page]]
            del self._adapter_of[page]
            self.evictions += 1
        elif self._free:
            page = self._free.pop()
        elif self._evictable:
            page, cold = self._evictable.popitem(last=False)
            del self._page_of[cold]
            del self._adapter_of[page]
            self.evictions += 1
        else:
            return None                        # all pages referenced
        self._write_page(page, entry, entry["scaling"], non_blocking)
        self.swapins += 1
        self._ref[page] = 1
        self._page_of[aid] = page
        self._adapter_of[page] = aid
        return page

    def prefetch(self, adapter_id, non_blocking=False):
        """Warm an adapter's page WITHOUT keeping a reference: swap in on a
        miss, then park it refcount-zero in the warm LRU so that the next
        `acquire` is a resident hit. Returns the page id, or None when no
        page is obtainable right now (it never evicts a live page).
        `non_blocking` as in `_write_page`: the engine's async core
        prefetches behind a step in flight."""
        aid = int(adapter_id)
        if aid == NULL_ADAPTER_ID:
            return 0
        if aid in self._page_of:
            return self._page_of[aid]          # already warm/live
        page = self.acquire(aid, non_blocking)
        if page is None:
            return None
        self.release(aid)                      # park warm, evictable
        return page

    def release(self, adapter_id):
        """Drop one reference; a page at refcount zero parks in the warm
        LRU (still resident). Raises on over-release."""
        aid = int(adapter_id)
        if aid == NULL_ADAPTER_ID:
            return
        page = self._page_of.get(aid)
        if page is None or self._ref[page] <= 0:
            raise RuntimeError(
                f"release of adapter {aid} with no live reference — a "
                "scheduler path double-released an adapter page")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._evictable[page] = aid        # newest LRU entry

    def leak_check(self):
        """Page-accounting audit of a QUIESCED pool (no live lanes): every
        non-null page must be free or parked refcount-zero in the warm LRU,
        and no rank group may hold more than its one page. Returns the
        leaked page ids."""
        free = set(self._free)
        leaked = []
        for p in range(1, self.num_pages):
            if self._ref[p] == 0 and (p in free or p in self._evictable):
                continue
            leaked.append(p)
        group_page = {}
        for aid, p in self._page_of.items():
            group = self.registry.group_of(aid)
            if group is None:
                continue
            if group in group_page:
                leaked.append(p)       # a second page for one group
            else:
                group_page[group] = p
        return leaked
