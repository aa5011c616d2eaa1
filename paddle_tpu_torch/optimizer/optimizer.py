"""Optimizer base: counterpart of paddle_tpu/optimizer/optimizer.py (analog of
python/paddle/optimizer/optimizer.py).

The update runs eagerly in place, parameter by parameter, in fp32 where
the JAX package computes in fp32; the accumulators are plain tensors on
each parameter's device. `step` clips the grads with `grad_clip` first,
then applies `_single_update` to every parameter that has a grad, then
counts the step.
"""
from __future__ import annotations

import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    """`parameters` is an iterable of tensors, or of (name, tensor) pairs
    such as `model.named_parameters()`; the names are what a per-parameter
    rule (AdamW's `apply_decay_param_fun`) sees, and are '' for bare
    tensors. `learning_rate` is a float or an `LRScheduler`, which the
    optimizer calls and never steps."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
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
        self._ensure_state()
        pg = [(p, p.grad) for p in self._parameter_list]
        if self._grad_clip is not None:
            pg = self._grad_clip(pg)
        if all(g is None for _, g in pg):
            return
        lr = self.get_lr()
        for i, (p, g) in enumerate(pg):
            if g is None:
                continue
            acc = {k: v[i] for k, v in self._accumulators.items()}
            self._single_update(i, p, g, acc, lr, self._step_count)
        self._step_count += 1

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

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
    def _fp32_zeros_like_params(self):
        return [torch.zeros_like(p, dtype=torch.float32,
                                 memory_format=torch.contiguous_format)
                for p in self._parameter_list]
