"""The optimizers: counterparts of paddle_tpu/optimizer/optimizers.py
(analogs of python/paddle/optimizer/{sgd,momentum,adam,adamw,adagrad,
rmsprop,adadelta,lamb}.py and paddle's Lars).

The update follows the JAX package's `_single_update` op for op, in fp32
(on the CPU this loop runs; on the card `ops.optimizer_update`'s kernel
applies the same ops, with the same roundings, to a whole group in one
pass, from `_kernel_spec`):
the grad and the parameter are read in fp32, the accumulators are kept
and updated in fp32 (Adam's and AdamW's `multi_precision=True`, the
default; `False` stores the moments in the parameter's dtype, as the JAX
package does), and the new parameter is rounded back to its own dtype
every step. There is no fp32 master copy of a bf16 parameter, because the
JAX package keeps none. `torch.optim` is not used: it orders the
operations differently and keeps bf16 state for bf16 parameters.

Lars and Lamb scale each parameter's step by norms over the whole
parameter; on the card a norm pass (`ops.optimizer_update.optimizer_norms`)
takes them before the update.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp",
           "Adadelta", "Lars", "Lamb"]


def _l2(g, pf, wd):
    """`g + wd * pf`, the L2 term of a float `weight_decay`, or `g`."""
    return g + wd * pf if wd else g


def _norm(x):
    return torch.sqrt(torch.sum(torch.square(x)))


class SGD(Optimizer):
    """`p - lr * g`; a `weight_decay` float is an L2 term added to the fp32
    grad."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _single_update(self, i, p, g, acc, lr, step):
        pf = p.float()
        g = _l2(g.float(), pf, self._weight_decay)
        p.copy_(pf - lr * g)

    def _kernel_spec(self, lr, step):
        return {"kind": "sgd", "accumulators": (),
                "hyper": {"lr": lr, "wd": self._weight_decay or 0.0}}


class Momentum(Optimizer):
    """Heavy-ball momentum: `v = momentum * v + g`, then `p - lr * v`, or
    `p - lr * (g + momentum * v)` with `use_nesterov`. The velocity is
    fp32; a `weight_decay` float is an L2 term added to the fp32 grad."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _create_accumulators(self):
        return {"velocity": self._full_like_params()}

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
                          "flag": int(bool(self._nesterov))}}


def _decayed(beta, a):
    """`beta * a` as the JAX package rounds it: an fp32 accumulator takes
    beta in fp32, a bf16 one beta rounded to bf16 (a weakly typed Python
    float) and gives a bf16 product."""
    if a.dtype == torch.float32:
        return beta * a
    return a * torch.tensor(beta, dtype=a.dtype, device=a.device)


class _Moments(Optimizer):
    """Adam's two moments, shared by Adam, AdamW and Lamb.

    `multi_precision=False` stores the moments in each parameter's dtype:
    the update still computes in fp32, and the new moments are rounded to
    that dtype every step. As in the JAX package, `beta * moment` then
    takes beta rounded to a bf16 moment's dtype (a Python float is weakly
    typed there; `beta2` 0.999 rounds to 1.0 in bf16)."""

    def __init__(self, learning_rate, beta1, beta2, epsilon, parameters,
                 weight_decay, grad_clip, multi_precision, name):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._multi_precision = bool(multi_precision)

    def _create_accumulators(self):
        dt = torch.float32 if self._multi_precision else None
        return {"moment1": self._full_like_params(dtype=dt),
                "moment2": self._full_like_params(dtype=dt)}

    def _corrections(self, step):
        """The bias corrections 1 - beta1**t and 1 - beta2**t at t = step
        + 1, taken in fp32 as the JAX package takes them (Python floats
        holding fp32 values)."""
        t = np.float32(step + 1)
        return tuple(float(np.float32(1) - np.power(np.float32(b), t))
                     for b in (self._beta1, self._beta2))

    def _moments(self, g, acc, step):
        """New moments (stored back into `acc`, rounded to its dtype) and
        their bias-corrected values, all fp32."""
        c1, c2 = self._corrections(step)
        m = _decayed(self._beta1, acc["moment1"]) + (1 - self._beta1) * g
        v = (_decayed(self._beta2, acc["moment2"])
             + (1 - self._beta2) * torch.square(g))
        acc["moment1"].copy_(m)
        acc["moment2"].copy_(v)
        return m / c1, v / c2

    def _moment_hyper(self, step):
        """The kernel's scalars for the moments: the betas, one minus each,
        epsilon, and the fp32 reciprocals of the bias corrections (a CUDA
        tensor divided by a Python scalar is a multiply by the scalar's
        fp32 reciprocal: the kernel multiplies by these)."""
        inv = [float(np.float32(1) / np.float32(c))
               for c in self._corrections(step)]
        return {"b1": self._beta1, "omb1": 1 - self._beta1,
                "b2": self._beta2, "omb2": 1 - self._beta2,
                "inv_c1": inv[0], "inv_c2": inv[1], "eps": self._epsilon}


class Adam(_Moments):
    """Adam; a `weight_decay` float is an L2 term added to the grad.
    `lazy_mode` is accepted and has no effect, as in the JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision, name)

    def _kernel_spec(self, lr, step):
        return {"kind": "adam", "accumulators": ("moment1", "moment2"),
                "multi_precision": self._multi_precision,
                "hyper": dict(self._moment_hyper(step), lr=lr,
                              wd=self._weight_decay or 0.0)}

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
    for bare tensors (the JAX GPT's parameters carry '' too). `lr_ratio`
    is accepted and has no effect, as in the JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision=multi_precision,
                         name=name)
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


class Adagrad(Optimizer):
    """`moment += g^2`, then `p - lr * g / (sqrt(moment) + eps)`; the
    moment starts at `initial_accumulator_value`. A `weight_decay` float is
    an L2 term added to the fp32 grad."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _create_accumulators(self):
        return {"moment": self._full_like_params(self._init_acc)}

    def _single_update(self, i, p, g, acc, lr, step):
        pf = p.float()
        g = _l2(g.float(), pf, self._weight_decay)
        mom = acc["moment"] + torch.square(g)
        acc["moment"].copy_(mom)
        p.copy_(pf - lr * g / (torch.sqrt(mom) + self._epsilon))

    def _kernel_spec(self, lr, step):
        return {"kind": "adagrad", "accumulators": ("moment",),
                "hyper": {"lr": lr, "eps": self._epsilon,
                          "wd": self._weight_decay or 0.0}}


class RMSProp(Optimizer):
    """`mean_square = rho * mean_square + (1 - rho) * g^2`; `centered`
    keeps `mean_grad` too and divides by sqrt(mean_square - mean_grad^2 +
    eps), else by sqrt(mean_square + eps); the momentum buffer holds
    `momentum * buffer + lr * g / denom`, which is subtracted from p."""

    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self):
        out = {"mean_square": self._full_like_params(),
               "momentum": self._full_like_params()}
        if self._centered:
            out["mean_grad"] = self._full_like_params()
        return out

    def _single_update(self, i, p, g, acc, lr, step):
        pf = p.float()
        g = _l2(g.float(), pf, self._weight_decay)
        rho = self._rho
        ms = rho * acc["mean_square"] + (1 - rho) * torch.square(g)
        if self._centered:
            mg = rho * acc["mean_grad"] + (1 - rho) * g
            denom = torch.sqrt(ms - torch.square(mg) + self._epsilon)
            acc["mean_grad"].copy_(mg)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * acc["momentum"] + lr * g / denom
        acc["mean_square"].copy_(ms)
        acc["momentum"].copy_(mom)
        p.copy_(pf - mom)

    def _kernel_spec(self, lr, step):
        # the row's third accumulator slot holds mean_grad
        names = ("mean_square", "momentum") + (
            ("mean_grad",) if self._centered else ())
        return {"kind": "rmsprop", "accumulators": names,
                "hyper": {"lr": lr, "rho": self._rho,
                          "omrho": 1 - self._rho, "eps": self._epsilon,
                          "mom": self._momentum,
                          "wd": self._weight_decay or 0.0,
                          "flag": int(bool(self._centered))}}


class Adadelta(Optimizer):
    """`upd = g * sqrt(avg_squared_update + eps) / sqrt(avg_squared_grad +
    eps)` from the new avg_squared_grad and the old avg_squared_update,
    then `p - lr * upd`."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self):
        return {"avg_squared_grad": self._full_like_params(),
                "avg_squared_update": self._full_like_params()}

    def _single_update(self, i, p, g, acc, lr, step):
        pf = p.float()
        g = _l2(g.float(), pf, self._weight_decay)
        rho, eps = self._rho, self._epsilon
        asg = rho * acc["avg_squared_grad"] + (1 - rho) * torch.square(g)
        upd = (g * torch.sqrt(acc["avg_squared_update"] + eps)
               / torch.sqrt(asg + eps))
        asu = rho * acc["avg_squared_update"] + (1 - rho) * torch.square(upd)
        acc["avg_squared_grad"].copy_(asg)
        acc["avg_squared_update"].copy_(asu)
        p.copy_(pf - lr * upd)

    def _kernel_spec(self, lr, step):
        return {"kind": "adadelta",
                "accumulators": ("avg_squared_grad", "avg_squared_update"),
                "hyper": {"lr": lr, "rho": self._rho,
                          "omrho": 1 - self._rho, "eps": self._epsilon,
                          "wd": self._weight_decay or 0.0}}


class Lars(Optimizer):
    """LARS: `v = momentum * v + lr * local_lr * (g + decay * p)`, then
    `p - v`, where `local_lr = lars_coeff * ||p|| / (||g|| + decay * ||p||
    + eps)` when both norms are positive, else 1. A parameter whose name
    holds one of the `exclude_from_weight_decay` substrings does not decay
    (names as AdamW's `apply_decay_param_fun` sees them)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=1e-9, exclude_from_weight_decay=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._momentum = momentum
        self._coeff = lars_coeff
        self._wd = lars_weight_decay
        self._epsilon = epsilon
        self._exclude = list(exclude_from_weight_decay or [])
        self._decay = [0.0 if any(s in n for s in self._exclude)
                       else float(self._wd) for n in self._parameter_names]

    def _create_accumulators(self):
        return {"velocity": self._full_like_params()}

    def _norm_operand(self, i, p, g, acc, step):
        """What the second norm is taken over: the fp32 grad."""
        return g.float()

    def _single_update(self, i, p, g, acc, lr, step):
        wd = self._decay[i]
        g = g.float()
        pf = p.float()
        w_norm, g_norm = _norm(pf), _norm(g)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._coeff * w_norm / (g_norm + wd * w_norm + self._epsilon),
            1.0)
        v = self._momentum * acc["velocity"] + lr * local_lr * (g + wd * pf)
        acc["velocity"].copy_(v)
        p.copy_(pf - v)

    def _kernel_spec(self, lr, step):
        return {"kind": "lars", "accumulators": ("velocity",),
                "decay": self._decay,
                "hyper": {"lr": lr, "mom": self._momentum,
                          "coeff": self._coeff, "eps": self._epsilon}}


class Lamb(_Moments):
    """LAMB: Adam's bias-corrected moments (fp32) give `r = mhat /
    (sqrt(vhat) + eps) + lamb_weight_decay * p`, and the step is `p - lr *
    trust * r` with `trust = ||p|| / ||r||` when both norms are positive,
    else 1. `exclude_from_weight_decay_fn` is accepted and has no effect,
    as in the JAX package."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, True, name)
        self._wd = lamb_weight_decay

    def _r(self, pf, g, acc, step):
        """The new moments into `acc`, and r from them."""
        mhat, vhat = self._moments(g.float(), acc, step)
        return mhat / (torch.sqrt(vhat) + self._epsilon) + self._wd * pf

    def _norm_operand(self, i, p, g, acc, step):
        """What the second norm is taken over: r, from the current
        moments, which stay as they are."""
        return self._r(p.float(), g, {k: a.clone() for k, a in acc.items()},
                       step)

    def _single_update(self, i, p, g, acc, lr, step):
        pf = p.float()
        r = self._r(pf, g, acc, step)
        w_norm, r_norm = _norm(pf), _norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        p.copy_(pf - lr * trust * r)

    def _kernel_spec(self, lr, step):
        return {"kind": "lamb", "accumulators": ("moment1", "moment2"),
                "hyper": dict(self._moment_hyper(step), lr=lr, wd=self._wd)}
