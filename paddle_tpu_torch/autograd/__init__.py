"""paddle.autograd namespace of the port (counterpart of
paddle_tpu/autograd): backward helpers, functional grad, and user-defined
PyLayer ops."""
from ..core.autograd import (enable_grad, grad, is_grad_enabled,  # noqa: F401
                             no_grad, run_backward, set_grad_enabled)
from ..core.pylayer import PyLayer, PyLayerContext  # noqa: F401


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Analog of paddle.autograd.backward."""
    run_backward(tensors, grad_tensors, retain_graph=retain_graph)


__all__ = ["PyLayer", "PyLayerContext", "backward", "grad", "no_grad",
           "enable_grad", "set_grad_enabled", "is_grad_enabled"]
