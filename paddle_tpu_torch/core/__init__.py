"""The paddle surface's core: dtypes, places, the random key chain, the
Tensor, autograd and PyLayer (counterpart of paddle_tpu/core)."""
from . import autograd, device, dtype, random
from .autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                       set_grad_enabled)
from .device import get_device, set_device
from .dtype import get_default_dtype, set_default_dtype
from .random import get_rng_state, seed, set_rng_state
from .tensor import Parameter, Tensor

__all__ = [
    "Tensor",
    "Parameter",
    "no_grad",
    "enable_grad",
    "grad",
    "set_device",
    "get_device",
    "seed",
    "set_default_dtype",
    "get_default_dtype",
]
