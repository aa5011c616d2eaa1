"""BatchNorm2D: counterpart of paddle_tpu/nn/norm.py.

`weight` (ones) and `bias` (zeros) are parameters; the running statistics
are the buffers `_mean` (zeros) and `_variance` (ones), under the JAX
layer's names, so that the weight bridge carries them and
`.to(torch.bfloat16)` casts them with the parameters, as JAX's `Layer.to`
does. NCHW. The forward is `ops.nn_ops.batch_norm`: in training mode its
training form (batch statistics; the running statistics updated in place
with `momentum`), unless `use_global_stats`, which keeps the inference
form from the running statistics, as in eval.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.nn_ops import batch_norm

__all__ = ["BatchNorm2D"]


class BatchNorm2D(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 use_global_stats=None, device=None, dtype=torch.float32):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._use_global_stats = use_global_stats
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.ones(num_features, **kw))
        self.bias = nn.Parameter(torch.zeros(num_features, **kw))
        self.register_buffer("_mean", torch.zeros(num_features, **kw))
        self.register_buffer("_variance", torch.ones(num_features, **kw))

    def forward(self, x):
        training = self.training and not self._use_global_stats
        return batch_norm(x, self._mean, self._variance, self.weight,
                          self.bias, training=training,
                          momentum=self._momentum, epsilon=self._epsilon)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")
