"""Mixed precision of the port: `GradScaler` (counterpart of
paddle_tpu/amp/grad_scaler.py). `auto_cast` is not ported: the JAX package
casts at op dispatch by the names of `ops/ops.yaml`, and the port's layers
call torch directly."""
from .grad_scaler import GradScaler

__all__ = ["GradScaler"]
