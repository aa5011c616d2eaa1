"""Conv2D: counterpart of paddle_tpu/nn/conv.py.

The weight is OIHW (paddle's layout, which is torch's too), drawn
KaimingUniform over fan_in = in_channels / groups * kh * kw (ReLU gain:
U(-sqrt(6 / fan_in), sqrt(6 / fan_in))); the bias U(-1/sqrt(fan_in),
1/sqrt(fan_in)), or none with `bias_attr=False`. Parameter names match
the JAX layer's (`weight`, `bias`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.conv import _pair
from ..ops.nn_ops import conv2d

__all__ = ["Conv2D"]


class Conv2D(nn.Module):
    """2-D convolution over NCHW (`ops.nn_ops.conv2d`). `device` and
    `dtype` as a torch layer takes them; the weights are drawn at
    construction from `generator` (a `torch.Generator` on `device`; seed
    0 when None, so a layer built on its own needs no global RNG)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _pair(kernel_size)
        self._stride = _pair(stride)
        self._padding = padding
        self._dilation = _pair(dilation)
        self._groups = groups
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *self._kernel_size, **kw))
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(torch.empty(out_channels, **kw))
        if generator is None:
            generator = torch.Generator(self.weight.device).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator):
        fan_in = self._in_channels // self._groups \
            * self._kernel_size[0] * self._kernel_size[1]
        limit = math.sqrt(2.0) * math.sqrt(3.0 / fan_in)
        self.weight.uniform_(-limit, limit, generator=generator)
        if self.bias is not None:
            bound = 1.0 / math.sqrt(fan_in)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self._stride, self._padding,
                      self._dilation, self._groups)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")
