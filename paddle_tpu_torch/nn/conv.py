"""Conv layers: counterpart of paddle_tpu/nn/conv.py
(python/paddle/nn/layer/conv.py), over the port's `ops.nn_ops`.

The weight is OIHW (paddle's layout, which is torch's too; IOHW for
`Conv2DTranspose`), drawn KaimingUniform over fan_in = in_channels /
groups * prod(kernel) (ReLU gain: U(-sqrt(6 / fan_in), sqrt(6 / fan_in)));
the bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (zeros for `Conv2DTranspose`),
or none with `bias_attr=False`. With no `generator` the draws come from
the key chain with JAX's initializers, so `paddle.seed(s)` gives JAX's
weights. The port's own keywords come last and keyword-only: `device`,
`dtype`, and `generator`, a `torch.Generator` the port's models pass to
draw the same two uniforms from it instead (an initializer that a
`ParamAttr` names still draws from the key chain).

`Conv2D` takes `data_format="NHWC"`. Where JAX ignores an option (a
`padding_mode` other than "zeros", the layout of `Conv1D`/`Conv3D`), the
port raises NotImplementedError (ROADMAP Queue C 29).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.tensor import plain
from ..ops import nn_ops
from . import initializer as I
from .layer import Layer, ParamAttr, refuse_ignored

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose"]


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


class _ConvBase(Layer):
    def __init__(self, device, dtype):
        super().__init__(dtype=dtype or "float32")
        self._place = device

    def _uniform_parameter(self, shape, attr, is_bias, default,
                           generator, limit):
        """A parameter drawn by `attr`'s initializer or `default` from the
        key chain, or U(-limit, limit) from `generator` when one is given
        and `attr` names no initializer. None when `attr` is False."""
        a = ParamAttr._to_attr(attr)
        if a is None:
            return None
        if generator is None or a.initializer is not None:
            return self.create_parameter(shape, attr, is_bias=is_bias,
                                         default_initializer=default)
        p = self.create_parameter(shape, attr, is_bias=is_bias,
                                  default_initializer=I.Constant(0.0))
        with torch.no_grad():
            plain(p).uniform_(-limit, limit, generator=generator)
        return p


class _ConvNd(_ConvBase):
    def __init__(self, in_channels, out_channels, kernel_size, nsp,
                 stride=1, padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 padding_mode="zeros", device=None, dtype=None,
                 generator=None):
        super().__init__(device, dtype)
        refuse_ignored(f"padding_mode={padding_mode!r}",
                       padding_mode != "zeros")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _pair(kernel_size, nsp)
        self._stride = _pair(stride, nsp)
        self._padding = padding
        self._dilation = _pair(dilation, nsp)
        self._groups = groups
        self._data_format = data_format
        fan_in = in_channels // groups * int(np.prod(self._kernel_size))
        w_shape = [out_channels, in_channels // groups] + list(
            self._kernel_size)
        self.weight = self._uniform_parameter(
            w_shape, weight_attr, False,
            I.KaimingUniform(fan_in=fan_in), generator,
            math.sqrt(2.0) * math.sqrt(3.0 / fan_in))
        bound = 1.0 / np.sqrt(fan_in)
        self.bias = self._uniform_parameter(
            [out_channels], bias_attr, True,
            I.Uniform(-bound, bound), generator, 1.0 / math.sqrt(fan_in))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, padding_mode, device, dtype, generator)

    def forward(self, x):
        return nn_ops.conv2d(x, self.weight, self.bias, self._stride,
                             self._padding, self._dilation, self._groups,
                             self._data_format)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype=None):
        refuse_ignored(f"Conv1D(data_format={data_format!r})",
                       data_format != "NCL")
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, padding_mode, device, dtype)

    def forward(self, x):
        return nn_ops.conv1d(x, self.weight, self.bias, self._stride,
                             self._padding, self._dilation, self._groups)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, dtype=None):
        refuse_ignored(f"Conv3D(data_format={data_format!r})",
                       data_format != "NCDHW")
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, padding_mode, device, dtype)

    def forward(self, x):
        return nn_ops.conv3d(x, self.weight, self.bias, self._stride,
                             self._padding, self._dilation, self._groups)


class Conv2DTranspose(_ConvBase):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None):
        super().__init__(device, dtype)
        refuse_ignored(f"Conv2DTranspose(data_format={data_format!r})",
                       data_format != "NCHW")
        self._stride = _pair(stride)
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = _pair(dilation)
        self._groups = groups
        ks = _pair(kernel_size)
        fan_in = in_channels * int(np.prod(ks))
        # paddle transpose-conv weight layout: [in, out//groups, kh, kw]
        self.weight = self.create_parameter(
            [in_channels, out_channels // groups] + list(ks),
            attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in))
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return nn_ops.conv2d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._dilation, self._groups)
