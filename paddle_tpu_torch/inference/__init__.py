"""Serving tier of the port (counterpart of paddle_tpu/inference)."""
from .engine import (PRIORITY_CLASSES, GenerationEngine, PagedKVCache,
                     Request, iter_prefix_key, prefix_key)
from .fleet import REPLICA_ROLES, ServingFleet
from .sampling import SamplingParams

__all__ = ["GenerationEngine", "PagedKVCache", "Request", "PRIORITY_CLASSES",
           "prefix_key", "iter_prefix_key", "SamplingParams", "ServingFleet",
           "REPLICA_ROLES"]
