"""Pooling layers: counterpart of paddle_tpu/nn/pooling.py
(python/paddle/nn/layer/pooling.py), over the port's `ops.nn_ops`. Each
layer takes JAX's parameters and passes its options on: where JAX ignores
one (`ceil_mode`, an NHWC `data_format` of the 2-D pools) the functional
op raises NotImplementedError (ROADMAP Queue C 29) rather than pool the
wrong windows."""
from __future__ import annotations

from ..ops import nn_ops

from .layer import Layer, refuse_ignored


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.data_format = data_format
        refuse_ignored("MaxPool2D(return_mask=True)", return_mask)

    def forward(self, x):
        return nn_ops.max_pool2d(x, self.kernel_size, self.stride,
                                 self.padding, self.ceil_mode,
                                 self.data_format)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.exclusive = exclusive
        self.ceil_mode = ceil_mode
        self.data_format = data_format
        refuse_ignored("AvgPool2D(divisor_override=)",
                       divisor_override is not None)

    def forward(self, x):
        return nn_ops.avg_pool2d(x, self.kernel_size, self.stride,
                                 self.padding, self.ceil_mode,
                                 count_include_pad=not self.exclusive,
                                 data_format=self.data_format)


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, name=None):
        super().__init__()
        refuse_ignored("MaxPool1D(ceil_mode=True)", ceil_mode)
        refuse_ignored("MaxPool1D(return_mask=True)", return_mask)
        self.kernel_size, self.stride = kernel_size, stride
        self.padding = padding

    def forward(self, x):
        return nn_ops.max_pool1d(x, self.kernel_size, self.stride,
                                 self.padding)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, name=None):
        super().__init__()
        refuse_ignored("AvgPool1D(ceil_mode=True)", ceil_mode)
        self.kernel_size, self.stride = kernel_size, stride
        self.padding = padding

    def forward(self, x):
        return nn_ops.avg_pool1d(x, self.kernel_size, self.stride,
                                 self.padding)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return nn_ops.adaptive_avg_pool2d(x, self.output_size,
                                          self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        refuse_ignored("AdaptiveMaxPool2D(return_mask=True)", return_mask)
        self.output_size = output_size

    def forward(self, x):
        return nn_ops.adaptive_max_pool2d(x, self.output_size)


class MaxPool3D(Layer):
    """python/paddle/nn/layer/pooling.py MaxPool3D; x [B,C,D,H,W]."""

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCDHW", name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding
        self.ceil_mode, self.return_mask = ceil_mode, return_mask
        self.data_format = data_format

    def forward(self, x):
        return nn_ops.max_pool3d(x, self.kernel_size, self.stride,
                                 self.padding, self.ceil_mode,
                                 self.return_mask, self.data_format)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None,
                 data_format="NCDHW", name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding
        self.exclusive = exclusive
        self.ceil_mode, self.divisor_override = ceil_mode, divisor_override
        self.data_format = data_format

    def forward(self, x):
        return nn_ops.avg_pool3d(x, self.kernel_size, self.stride,
                                 self.padding, self.ceil_mode,
                                 self.exclusive, self.divisor_override,
                                 self.data_format)
