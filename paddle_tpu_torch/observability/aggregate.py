"""Distributed metric aggregation: fold per-rank snapshots to job-level
(counterpart of paddle_tpu/observability/aggregate.py).

Every rank in the group calls `aggregate()` (collective contract — same
order on every member); each receives the merged result. The JAX package
moves the serialized snapshots through its eager collectives (a MAX
all-reduce of the payload sizes, then one all-gather) and folds them with
`merge_snapshots`. The port has no collective tier yet (ROADMAP Queue A
13, `distributed/*`), so only the single-member path runs here: the local
snapshot through the same merge, which is what the JAX package returns
with one participant. A group of more members raises.
"""
from __future__ import annotations

from .metrics import get_registry, merge_snapshots

__all__ = ["aggregate"]


def _member_count(group):
    """Members of `group`: an object with `.ranks`, a torch process group,
    or None for the default group (one member outside a distributed
    context)."""
    ranks = getattr(group, "ranks", None)
    if ranks is not None:
        return len(tuple(ranks))
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def aggregate(group=None, registry=None):
    """Merge every group member's registry snapshot; returns the merged
    snapshot dict. With one participant (or outside a distributed
    context) this is the local snapshot run through the merge path, as in
    the JAX package; with more it raises NotImplementedError."""
    reg = registry if registry is not None else get_registry()
    local = reg.snapshot()
    if _member_count(group) <= 1:
        return merge_snapshots([local])
    raise NotImplementedError(
        "aggregate over more than one member needs the collective tier "
        "(distributed/collective), which is not ported yet (ROADMAP "
        "Queue A 13)")
