"""GradScaler: counterpart of paddle_tpu/amp/grad_scaler.py (analog of
python/paddle/amp/grad_scaler.py), all of it.

Dynamic loss scaling for the eager loop: `scale(loss)` multiplies the loss,
`step(optimizer)` unscales the grads, skips the update when any is not
finite, and `update()` moves the scale. `TrainStep(scaler=)` reads the
scale and sets `_found_inf` itself, with its own unscale (a divide, inside
the step: `jit.api`).

The eager `unscale_` multiplies each grad by the Python float `1 / scale`
and checks it for finiteness after the multiply, as the JAX package does.
There that float is weakly typed: against a bf16 grad it is rounded to bf16
before the multiply, and the port rounds it the same way (and `scale`'s
factor likewise).
"""
from __future__ import annotations

import torch

__all__ = ["GradScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, var):
        """`var * scale`, the scale in `var`'s dtype (a weakly typed
        Python float in the JAX package)."""
        if not self._enable:
            return var
        return var * torch.tensor(self._scale, dtype=var.dtype,
                                  device=var.device)

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Multiply every grad the optimizer holds by `1 / scale` (the
        scalar in the grad's dtype) and note whether any result is not
        finite; once per step."""
        if not self._enable or self._unscaled:
            return
        self._unscaled = True
        inv = 1.0 / self._scale
        found = []
        for p in optimizer._parameter_list:
            if p.grad is not None:
                g = p.grad * torch.tensor(inv, dtype=p.grad.dtype,
                                          device=p.grad.device)
                found.append(~torch.isfinite(g).all())
                p.grad = g
        self._found_inf = bool(torch.stack(found).any()) if found else False

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        self._unscaled = False
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def get_scale(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state["good_steps"]
        self._bad_steps = state["bad_steps"]
