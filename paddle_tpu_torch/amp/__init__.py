"""Mixed precision of the port (counterpart of paddle_tpu/amp):
`auto_cast` (casts at op dispatch by the op schema's lists) and
`GradScaler`."""
from .auto_cast import BLACK_LIST, WHITE_LIST, amp_state, auto_cast
from .grad_scaler import GradScaler

autocast = auto_cast

__all__ = ["auto_cast", "autocast", "GradScaler", "WHITE_LIST", "BLACK_LIST"]
