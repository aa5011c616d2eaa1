"""Normalization layers: counterpart of paddle_tpu/nn/norm.py
(python/paddle/nn/layer/norm.py), each over the port's functional ops.

BatchNorm's `weight` (ones) and `bias` (zeros) are parameters (either
dropped with `weight_attr=False` / `bias_attr=False`); the running
statistics are the buffers `_mean` (zeros) and `_variance` (ones), in the
layer's dtype (float32 unless the port's `dtype=` says otherwise),
under the JAX layer's names, so that the weight bridge carries them and
`Layer.to` casts them with the parameters. The forward is
`ops.nn_ops.batch_norm` over the channel axis of `data_format` ("NCHW" or
"NHWC"): in training mode its training form (batch statistics; the running
statistics updated in place with `momentum`), unless `use_global_stats`,
which keeps the inference form, as in eval.

The port's own keywords, `device` and `dtype`, come last and keyword-only
(`Layer` explains where parameters land).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.tensor import Tensor
from ..ops import nn_ops, threefry
from ..ops.dispatch import apply, as_tensor
from ..core.random import next_key
from . import initializer as I
from .layer import Layer

__all__ = ["BatchNorm2D", "BatchNorm1D", "BatchNorm3D", "BatchNorm",
           "SyncBatchNorm", "LayerNorm", "RMSNorm", "GroupNorm",
           "InstanceNorm2D", "LocalResponseNorm", "SpectralNorm"]


class _Norm(Layer):
    def __init__(self, device, dtype):
        super().__init__(dtype=dtype or "float32")
        self._place = device


class BatchNorm2D(_Norm):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(device, dtype)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True)
        kw = dict(device=self._device(), dtype=dtypes.to_torch(self._dtype))
        self.register_buffer("_mean", Tensor(torch.zeros(num_features, **kw)))
        self.register_buffer("_variance",
                             Tensor(torch.ones(num_features, **kw)))

    def forward(self, x):
        training = self.training and not self._use_global_stats
        return nn_ops.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm1D(BatchNorm2D):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, *, device=None, dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW", device=device, dtype=dtype)
        self._data_format = "NCHW"  # reduce over all but axis 1 regardless


class BatchNorm3D(BatchNorm2D):
    pass


BatchNorm = BatchNorm2D


class SyncBatchNorm(BatchNorm2D):
    """On one device, BatchNorm2D, as in JAX (whose statistics span the
    global batch only inside a data-parallel compiled step)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        return layer


class LayerNorm(_Norm):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(device, dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return nn_ops.layer_norm(x, self._normalized_shape, self.weight,
                                 self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(_Norm):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, *,
                 device=None, dtype=None):
        super().__init__(device, dtype)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return nn_ops.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(_Norm):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__(device, dtype)
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return nn_ops.group_norm(x, self._num_groups, self.weight, self.bias,
                                 self._epsilon)


class InstanceNorm2D(_Norm):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__(device, dtype)
        self._epsilon = epsilon
        self.scale = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return nn_ops.instance_norm(x, self.scale, self.bias, self._epsilon)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW"):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return nn_ops.local_response_norm(
            x, self.size, alpha=self.alpha, beta=self.beta, k=self.k)


class SpectralNorm(_Norm):
    """Spectral normalization (python/paddle/nn/layer/norm.py
    SpectralNorm): weight / sigma_max, sigma estimated by `power_iters`
    steps of power iteration every forward. The vectors `weight_u` and
    `weight_v` are buffers, drawn at construction from the key chain (one
    key split in two, a normal draw each, normalized, as JAX draws them),
    and advanced by a forward in training mode only; no gradient flows
    through them."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, dtype="float32", *, device=None):
        super().__init__(device, dtype)
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        h = int(weight_shape[dim])
        w = int(np.prod(weight_shape)) // h
        k1, k2 = threefry.split(next_key())
        dev = self._device()
        u = threefry.normal(k1, (h,), torch.float32, dev)
        v = threefry.normal(k2, (w,), torch.float32, dev)
        self.register_buffer("weight_u", Tensor(u / torch.linalg.norm(u)))
        self.register_buffer("weight_v", Tensor(v / torch.linalg.norm(v)))

    def forward(self, weight):
        dim, iters, eps = self.dim, self.power_iters, self.eps

        def fn(w, u, v):
            perm = (dim,) + tuple(i for i in range(w.ndim) if i != dim)
            m = w.permute(perm).reshape(w.shape[dim], -1)
            with torch.no_grad():
                md = m.detach()
                uu, vv = u, v
                for _ in range(iters):
                    vv = md.T @ uu
                    vv = vv / (torch.linalg.norm(vv) + eps)
                    uu = md @ vv
                    uu = uu / (torch.linalg.norm(uu) + eps)
            sigma = uu @ (m @ vv)
            return w / sigma, uu, vv

        out, u2, v2 = apply("spectral_norm", fn, as_tensor(weight),
                            self.weight_u, self.weight_v)
        if self.training:
            with torch.no_grad():
                self.weight_u.copy_(u2)
                self.weight_v.copy_(v2)
        return out
