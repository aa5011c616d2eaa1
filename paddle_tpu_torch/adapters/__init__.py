"""Multi-tenant adapter serving: paged batched LoRA over the generation
engine (counterpart of paddle_tpu/adapters).

One base model, many per-tenant tuned adapters. Three tiers:

- `AdapterRegistry` (registry.py): host-side store of rank-padded LoRA
  A/B factors per tenant (adapter id 0 = the null/base adapter);
- `PagedAdapterPool` (pool.py): active adapters on the device, paged with
  the PagedKVCache's block/refcount/LRU and stall-and-retry pattern,
  swapped in from the registry on a miss (`adapter_pool_spec` is the
  single layout truth);
- `ops.lora`: the batched apply, each slot's A/B pages read by a per-slot
  page row and added to the qkv/out/fc1/fc2 projections with fp32
  accumulation (`batched_lora`, a hand-written kernel on the card).

The serving engine wires them together:
`GenerationEngine(model, adapters=registry)` and
`add_request(..., adapter_id=7)`.
"""
from .pool import PagedAdapterPool, adapter_pool_spec
from .registry import NULL_ADAPTER_ID, AdapterRegistry

__all__ = ["AdapterRegistry", "PagedAdapterPool", "adapter_pool_spec",
           "NULL_ADAPTER_ID"]
