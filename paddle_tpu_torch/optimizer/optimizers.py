"""Momentum, Adam and AdamW: counterparts of
paddle_tpu/optimizer/optimizers.py (analogs of
python/paddle/optimizer/{momentum,adam,adamw}.py).

The update follows the JAX package's `_single_update` op for op, in fp32
(on the CPU this loop runs; on the card `ops.optimizer_update`'s kernel
applies the same ops, with the same roundings, to a whole group in one
pass, from `_kernel_spec`):
the grad and the parameter are read in fp32, Momentum's velocity and
Adam's moments are kept,
updated and bias-corrected in fp32 (the JAX package's
`multi_precision=True`), and the new parameter is rounded back to its own
dtype every step. There is no fp32 master copy of a bf16 parameter,
because the JAX package keeps none. `torch.optim.AdamW` is not used: it
orders the operations differently and keeps bf16 moments for bf16
parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["Momentum", "Adam", "AdamW"]


class Momentum(Optimizer):
    """Heavy-ball momentum: `v = momentum * v + g`, then `p - lr * v`, or
    `p - lr * (g + momentum * v)` with `use_nesterov`. The velocity is
    fp32; a `weight_decay` float is an L2 term added to the fp32 grad."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _create_accumulators(self):
        return {"velocity": self._fp32_zeros_like_params()}

    def _single_update(self, i, p, g, acc, lr, step):
        g = g.float()
        pf = p.float()
        if self._weight_decay:
            g = g + self._weight_decay * pf
        v = self._momentum * acc["velocity"] + g
        acc["velocity"].copy_(v)
        upd = g + self._momentum * v if self._nesterov else v
        p.copy_(pf - lr * upd)

    def _kernel_spec(self, lr, step):
        return {"kind": "momentum", "accumulators": ("velocity",),
                "hyper": {"lr": lr, "mom": self._momentum,
                          "wd": self._weight_decay or 0.0,
                          "nesterov": int(bool(self._nesterov))}}


class Adam(Optimizer):
    """Adam; a `weight_decay` float is an L2 term added to the grad."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self):
        return {"moment1": self._fp32_zeros_like_params(),
                "moment2": self._fp32_zeros_like_params()}

    def _corrections(self, step):
        """The bias corrections 1 - beta1**t and 1 - beta2**t at t = step
        + 1, taken in fp32 as the JAX package takes them (Python floats
        holding fp32 values)."""
        t = np.float32(step + 1)
        return tuple(float(np.float32(1) - np.power(np.float32(b), t))
                     for b in (self._beta1, self._beta2))

    def _moments(self, g, acc, step):
        """New moments (stored back into `acc`) and their bias-corrected
        values, all fp32."""
        c1, c2 = self._corrections(step)
        m = self._beta1 * acc["moment1"] + (1 - self._beta1) * g
        v = self._beta2 * acc["moment2"] + (1 - self._beta2) * torch.square(g)
        acc["moment1"].copy_(m)
        acc["moment2"].copy_(v)
        return m / c1, v / c2

    def _kernel_spec(self, lr, step):
        # a CUDA tensor divided by a Python scalar is a multiply by the
        # scalar's fp32 reciprocal: the kernel multiplies by these
        inv = [float(np.float32(1) / np.float32(c))
               for c in self._corrections(step)]
        return {"kind": "adam", "accumulators": ("moment1", "moment2"),
                "hyper": {"b1": self._beta1, "omb1": 1 - self._beta1,
                          "b2": self._beta2, "omb2": 1 - self._beta2,
                          "inv_c1": inv[0], "inv_c2": inv[1],
                          "eps": self._epsilon, "lr": lr,
                          "wd": self._weight_decay or 0.0}}

    def _single_update(self, i, p, g, acc, lr, step):
        g = g.float()
        pf = p.float()
        if self._weight_decay:
            g = g + self._weight_decay * pf
        mhat, vhat = self._moments(g, acc, step)
        p.copy_(pf - lr * mhat / (torch.sqrt(vhat) + self._epsilon))


class AdamW(Adam):
    """Adam with decoupled weight decay:
    p - lr * (mhat / (sqrt(vhat) + eps) + wd * p).

    `apply_decay_param_fun(name)` picks the parameters that decay (all by
    default). It sees the names the optimizer was given: the port's
    parameter names when `parameters` is `model.named_parameters()`, ''
    for bare tensors (the JAX GPT's parameters carry '' too)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._wd = float(weight_decay) if weight_decay else 0.0
        fn = apply_decay_param_fun
        self._decay = [self._wd if fn is None or fn(n) else 0.0
                       for n in self._parameter_names]

    def _single_update(self, i, p, g, acc, lr, step):
        g = g.float()
        pf = p.float()
        mhat, vhat = self._moments(g, acc, step)
        p.copy_(pf - lr * (mhat / (torch.sqrt(vhat) + self._epsilon)
                           + self._decay[i] * pf))

    def _kernel_spec(self, lr, step):
        spec = super()._kernel_spec(lr, step)
        spec.update(kind="adamw", decay=self._decay)
        return spec
