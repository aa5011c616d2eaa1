"""Autograd of the paddle surface: counterpart of
paddle_tpu/core/autograd.py (paddle/fluid/eager/backward.cc:105
RunBackward, eager/general_grad.h).

JAX's package records a tape of jax VJP closures and walks it itself;
the port's tensors are torch tensors, so the tape is torch's autograd
graph and these are its paddle-shaped entry points:

- `no_grad`, `enable_grad`, `set_grad_enabled`, `is_grad_enabled`:
  torch's grad mode (`set_grad_enabled(mode)` sets it, as JAX's does,
  rather than returning a context);
- `run_backward(tensors, grad_tensors, retain_graph)`: one backward from
  several roots. As in JAX, a root without a gradient seeds ones of its
  shape (a non-scalar root too), a root that does not require grad is
  skipped, and the graph is freed unless `retain_graph`: a second
  backward through it raises;
- `grad(outputs, inputs, grad_outputs, retain_graph, create_graph,
  allow_unused)`: gradients without touching `.grad`. As in JAX, an input
  the outputs do not reach gets zeros unless `allow_unused`, then None
  (JAX never raises for it), and an input that does not require grad is
  such an input. `create_graph` builds the gradients' own graph (torch's
  double backward; JAX's eager tape returns them detached).
"""
from __future__ import annotations

import torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "grad", "run_backward"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    torch._C._set_grad_enabled(bool(mode))


def _as_list(x):
    if x is None:
        return None
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _seed(t, g):
    if g is None:
        return torch.ones_like(t)
    return g if isinstance(g, torch.Tensor) else torch.as_tensor(
        g, dtype=t.dtype, device=t.device)


def run_backward(tensors, grad_tensors=None, retain_graph: bool = False):
    """Backward from `tensors` (seeded by `grad_tensors`, ones where None)
    into the `.grad` of every leaf that requires grad."""
    tensors = _as_list(tensors)
    grads = _as_list(grad_tensors) or [None] * len(tensors)
    roots = [(t, _seed(t, g)) for t, g in zip(tensors, grads)
             if t.requires_grad]
    if not roots:
        return
    torch.autograd.backward([t for t, _ in roots], [g for _, g in roots],
                            retain_graph=bool(retain_graph))


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """Gradients of `outputs` with respect to `inputs` (paddle.grad),
    without touching any `.grad`."""
    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    gouts = _as_list(grad_outputs) or [None] * len(outputs)
    roots = [(o, _seed(o, g)) for o, g in zip(outputs, gouts)
             if o.requires_grad]
    live = [i for i, t in enumerate(inputs) if t.requires_grad]
    found = [None] * len(inputs)
    if roots and live:
        got = torch.autograd.grad(
            [o for o, _ in roots], [inputs[i] for i in live],
            [g for _, g in roots], retain_graph=bool(retain_graph)
            or create_graph, create_graph=create_graph, allow_unused=True)
        for i, g in zip(live, got):
            found[i] = g
    from .tensor import Tensor

    out = []
    for t, g in zip(inputs, found):
        if g is None and not allow_unused:
            g = torch.zeros_like(t)
        out.append(None if g is None else g.as_subclass(Tensor))
    return out
