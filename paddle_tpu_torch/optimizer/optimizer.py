"""Optimizer base: counterpart of paddle_tpu/optimizer/optimizer.py (analog of
python/paddle/optimizer/optimizer.py).

The update runs eagerly in place, in fp32 where the JAX package computes
in fp32; the accumulators are plain tensors on each parameter's device.
`step` clips the grads with `grad_clip` first, then updates every
parameter that has a grad, then counts the step; `TrainStep` hands its own
grads to the same update (`_update`). The parameters are
updated in groups of one device and one dtype through
`ops.optimizer_update`: on the card one kernel launch a group applies
`_single_update`'s arithmetic to all of them in one pass (the JAX
package's one fused program), on the CPU the plain version loops over
`_single_update`.
"""
from __future__ import annotations

import torch

from ..ops.optimizer_update import optimizer_update
from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    """`parameters` is an iterable of tensors, or of (name, tensor) pairs
    such as `model.named_parameters()`; the names are what a per-parameter
    rule (AdamW's `apply_decay_param_fun`) sees, and are '' for bare
    tensors. `learning_rate` is a float or an `LRScheduler`, which the
    optimizer calls and never steps. `name` is accepted and has no effect,
    as in the JAX package."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        named = [item if isinstance(item, tuple) else ("", item)
                 for item in parameters]
        self._parameter_names = [n for n, _ in named]
        self._parameter_list = [p for _, p in named]
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._weight_decay = (None if weight_decay is None
                              else float(weight_decay))
        # per-parameter accumulator slots: name -> list aligned with params
        self._accumulators = {}
        self._step_count = 0

    # -- subclass interface -------------------------------------------------
    def _create_accumulators(self):
        """name -> list of zero-initialized tensors, one per parameter."""
        return {}

    def _single_update(self, i, p, g, acc, lr, step):
        """Update parameter `i` (`p`, grad `g`) and its accumulators `acc`
        ({name: tensor}) in place, at learning rate `lr` and 0-based step
        count `step`."""
        raise NotImplementedError

    def _kernel_spec(self, lr, step):
        """What the one-pass kernel needs to apply `_single_update`: the
        rule (`kind`, a key of `ops.optimizer_update.KINDS`), the names of
        its accumulators (none to three, in the kernel's order), the
        scalars (`hyper`) and, for AdamW and Lars, the per-parameter
        `decay`."""
        raise NotImplementedError(f"{type(self).__name__} has no one-pass "
                                  "kernel on the card yet")

    # -- public api ----------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("can't set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def _ensure_state(self):
        if not self._accumulators:
            self._accumulators = self._create_accumulators()

    @torch.no_grad()
    def step(self):
        self._update([(p, p.grad) for p in self._parameter_list])

    @torch.no_grad()
    def _update(self, pg):
        """Clip and apply one step to `pg`, the (parameter, grad or None)
        pairs aligned with the parameter list; parameters whose grad is
        None are left alone. Counts the step unless every grad is None."""
        self._ensure_state()
        if self._grad_clip is not None:
            pg = self._grad_clip(pg)
        if all(g is None for _, g in pg):
            return
        lr = self.get_lr()
        for group in self._groups(pg):
            optimizer_update(self, group, lr, self._step_count)
        self._step_count += 1

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """`loss.backward()`, `step()`, `clear_grad()`; the other arguments
        are accepted and unused, as in the JAX package."""
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    @staticmethod
    def _groups(pg):
        """The parameters with a grad as lists of (index, parameter, grad),
        one list per (device, dtype), in order of first appearance."""
        groups = {}
        for i, (p, g) in enumerate(pg):
            if g is not None:
                groups.setdefault((p.device, p.dtype), []).append((i, p, g))
        return list(groups.values())

    def clear_grad(self, set_to_zero=False):
        """Drop every parameter's grad. `set_to_zero` is accepted and has
        no effect: the JAX package drops the grads either way."""
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    # -- state dict -----------------------------------------------------------
    def state_dict(self):
        self._ensure_state()
        out = {"_step_count": self._step_count}
        for k, lst in self._accumulators.items():
            for i, a in enumerate(lst):
                out[f"{k}_{i}"] = a
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        """Load a `state_dict`; accumulators keep this optimizer's storage
        dtype and device whatever the saved ones were."""
        self._ensure_state()
        self._step_count = int(state.get("_step_count", 0))
        for k, lst in self._accumulators.items():
            for i, a in enumerate(lst):
                v = state.get(f"{k}_{i}")
                if v is not None:
                    a.copy_(torch.as_tensor(v))
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])

    # -- helpers --------------------------------------------------------------
    def _full_like_params(self, value=0.0, dtype=torch.float32):
        """`value` (zeros by default) in each parameter's shape and layout
        (a channels_last weight gets channels_last accumulators, as the
        one-pass kernel walks them), fp32 or, with `dtype` None, in the
        parameter's own dtype."""
        return [torch.full_like(p, value, dtype=dtype or p.dtype)
                for p in self._parameter_list]
