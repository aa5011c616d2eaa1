"""The framework tier of the paddle surface (counterpart of
paddle_tpu/framework): the `FLAGS_*` registry, the NaN/Inf checks it
switches on, and `save`/`load`. The JAX package's `sharded_io` (each
process's addressable shards of a jax array) waits for the port's
`distributed` collectives."""
from . import flags, io, nan_inf
from .flags import get_flags, set_flags
from .io import load, save

__all__ = ["save", "load", "set_flags", "get_flags", "flags", "io",
           "nan_inf"]
