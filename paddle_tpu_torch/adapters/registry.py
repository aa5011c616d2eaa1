"""Per-tenant LoRA adapter registry, the HOST-side half of the multi-tenant
adapter subsystem: a copy of paddle_tpu/adapters/registry.py (pure numpy),
so that the same factors registered in both packages are the same weights.

An `AdapterRegistry` owns every tenant's low-rank factors in the
device-pool layout (rank-padded to a fixed `max_rank`, B factors
re-grouped to the serving engine's output layouts), so the paged pool
(`adapters.pool.PagedAdapterPool`) can swap an adapter in with one copy
per site and one set of shapes serves every rank. Adapter id 0 is
reserved: the null/base adapter (no registration, all-zero factors, zero
scaling); a request carrying id 0 decodes bit-identically to an engine
with no adapter subsystem.

Registration takes standard LoRA factors per target site per layer:
`A [rank, in]`, `B [out, rank]` with `delta_W = B @ A` and the applied
update `x -> x + (x A^T B^T) * scaling` (scaling defaults to
`alpha / rank` when `alpha` is given). Sites an adapter does not tune
stay exact-zero: a per-site/per-layer no-op.
"""
from __future__ import annotations

import numpy as np

from ..ops.lora import LORA_SITES

__all__ = ["AdapterRegistry", "NULL_ADAPTER_ID"]

#: Reserved id of the null/base adapter (pool page 0, all zeros).
NULL_ADAPTER_ID = 0


class AdapterRegistry:
    """Host-side store of rank-padded per-tenant LoRA factors.

        reg = AdapterRegistry(model.config, max_rank=8)
        reg.register(7, {"qkv": [(A0, B0), (A1, B1)]}, alpha=16)

    `config` is a GPTConfig-like object (num_layers, hidden_size,
    intermediate_size, num_heads). The registry is pure numpy — no
    device state; the paged pool reads `stacks(adapter_id)` to swap a
    tenant in."""

    def __init__(self, config, max_rank=8, dtype=np.float32):
        if max_rank < 1:
            raise ValueError(f"max_rank must be >= 1, got {max_rank}")
        self.max_rank = int(max_rank)
        self.dtype = np.dtype(dtype)
        self.num_layers = int(config.num_layers)
        self.hidden_size = int(config.hidden_size)
        self.intermediate_size = int(config.intermediate_size)
        self.num_heads = int(config.num_heads)
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size={self.hidden_size} not divisible by "
                f"num_heads={self.num_heads}")
        self.head_dim = self.hidden_size // self.num_heads
        self._adapters = {}            # id -> {site stacks + scaling}
        self._groups = {}              # group key -> set of ids

    # -- site geometry ----------------------------------------------------
    def site_dims(self, site):
        """(in_dim, out_dim) of one target matmul."""
        H, I = self.hidden_size, self.intermediate_size
        return {"qkv": (H, 3 * H), "out": (H, H), "fc1": (H, I),
                "fc2": (I, H)}[site]

    # -- registration -----------------------------------------------------
    def register(self, adapter_id, weights, scaling=None, alpha=None,
                 group=None):
        """Register one tenant's adapter. `weights` maps a site name
        (one of LORA_SITES) to a per-layer sequence of `(A, B)` pairs
        (None skips a layer). A is `[rank, in]`, B `[out, rank]`,
        rank <= max_rank — rank-padded to the fixed pool shape with
        exact zeros. `scaling` defaults to `alpha / rank` (alpha given)
        or 1.0. Re-registering a live id raises — tenants update via a
        new id, so a pool page can never silently serve stale bytes.

        `group` (any hashable key) declares a RANK GROUP: one tenant's
        adapter shipped at several ranks (quality/latency variants of
        the same LoRA — the grouped multi-rank tail of the paged-pool
        design). Members of a group share ONE page budget in the paged
        pool: acquiring one variant reuses (and evicts) an idle
        sibling's page in place instead of taking a second page, and
        the pool's leak audit asserts no group ever holds two."""
        aid = int(adapter_id)
        if aid == NULL_ADAPTER_ID:
            raise ValueError(
                "adapter id 0 is reserved for the null/base adapter")
        if aid < 0:
            raise ValueError(f"adapter ids are >= 1, got {aid}")
        if aid in self._adapters:
            raise ValueError(
                f"adapter {aid} is already registered — tenants ship "
                "updates under a fresh id")
        if not weights:
            raise ValueError("an adapter must tune at least one site")
        unknown = set(weights) - set(LORA_SITES)
        if unknown:
            raise ValueError(
                f"unknown LoRA site(s) {sorted(unknown)} — targets are "
                f"{LORA_SITES}")
        L, R = self.num_layers, self.max_rank
        entry = {"rank": 0}
        ranks_seen = set()
        for site in LORA_SITES:
            in_d, out_d = self.site_dims(site)
            a_stack = np.zeros((L, R, in_d), self.dtype)
            b_stack = np.zeros((L, R, out_d), self.dtype)
            per_layer = weights.get(site)
            if per_layer is not None:
                if len(per_layer) != L:
                    raise ValueError(
                        f"site {site!r}: expected {L} per-layer "
                        f"entries, got {len(per_layer)}")
                for li, pair in enumerate(per_layer):
                    if pair is None:
                        continue
                    A, B = pair
                    A = np.asarray(A, self.dtype)
                    B = np.asarray(B, self.dtype)
                    r = A.shape[0]
                    if r < 1 or r > R:
                        raise ValueError(
                            f"site {site!r} layer {li}: rank {r} "
                            f"outside [1, max_rank={R}]")
                    if A.shape != (r, in_d) or B.shape != (out_d, r):
                        raise ValueError(
                            f"site {site!r} layer {li}: want A "
                            f"[{r}, {in_d}] and B [{out_d}, {r}], got "
                            f"A {A.shape} / B {B.shape}")
                    a_stack[li, :r] = A
                    b_stack[li, :r] = B.T
                    ranks_seen.add(r)
                    entry["rank"] = max(entry["rank"], r)
            entry["a_" + site] = a_stack
            entry["b_" + site] = self._b_layout(site, b_stack)
        if entry["rank"] == 0:
            raise ValueError("an adapter must tune at least one "
                             "(site, layer) pair")
        if scaling is None:
            if alpha is not None and len(ranks_seen) > 1:
                # standard LoRA scales each module by alpha/r_module;
                # ONE adapter-wide scaling cannot express that —
                # silently picking a rank would under/over-drive the
                # other sites vs the checkpoint's intent
                raise ValueError(
                    f"alpha with mixed ranks {sorted(ranks_seen)} is "
                    "ambiguous (per-module alpha/rank differs) — pass "
                    "an explicit scaling, or pad the factors to one "
                    "rank")
            scaling = 1.0 if alpha is None else float(alpha) / \
                entry["rank"]
        elif alpha is not None:
            raise ValueError("pass scaling OR alpha, not both")
        entry["scaling"] = float(scaling)
        entry["group"] = group
        self._adapters[aid] = entry
        if group is not None:
            self._groups.setdefault(group, set()).add(aid)
        return aid

    def _b_layout(self, site, b_stack):
        """Re-group a site's `[L, R, out]` B stack into the pool/apply
        layout: qkv becomes head-grouped `[L, R, heads, 3, D]` (the
        `_tp_plan` column-parallel qkv order, so the pool can shard it
        on the heads axis); linear sites stay `[L, R, out]`."""
        if site != "qkv":
            return b_stack
        L, R = b_stack.shape[:2]
        # out index o = (t*heads + h)*D + d  ->  [h, t, d]
        return b_stack.reshape(
            L, R, 3, self.num_heads, self.head_dim).transpose(
                0, 1, 3, 2, 4)

    # -- lookup -----------------------------------------------------------
    def has(self, adapter_id):
        return int(adapter_id) == NULL_ADAPTER_ID \
            or int(adapter_id) in self._adapters

    def ids(self):
        """Registered (non-null) adapter ids, sorted."""
        return sorted(self._adapters)

    def rank_of(self, adapter_id):
        if int(adapter_id) == NULL_ADAPTER_ID:
            return 0
        return self._adapters[int(adapter_id)]["rank"]

    def scaling_of(self, adapter_id):
        if int(adapter_id) == NULL_ADAPTER_ID:
            return 0.0
        return self._adapters[int(adapter_id)]["scaling"]

    def group_of(self, adapter_id):
        """The rank-group key an adapter was registered under (None
        for ungrouped adapters and the null adapter)."""
        aid = int(adapter_id)
        if aid == NULL_ADAPTER_ID or aid not in self._adapters:
            return None
        return self._adapters[aid].get("group")

    def group_ids(self, group):
        """Sorted member ids of one rank group (empty when unknown)."""
        return sorted(self._groups.get(group, ()))

    def stacks(self, adapter_id):
        """The pool-layout host arrays of one adapter:
        {a_<site>/b_<site>: ndarray, scaling: float} — what the paged
        pool copies onto a device page at swap-in."""
        aid = int(adapter_id)
        if aid == NULL_ADAPTER_ID:
            raise KeyError("the null adapter has no stacks — page 0 "
                           "is permanently zero")
        if aid not in self._adapters:
            raise KeyError(f"adapter {aid} is not registered")
        return self._adapters[aid]

    def __len__(self):
        return len(self._adapters)
