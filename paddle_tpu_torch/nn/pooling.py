"""MaxPool2D and AdaptiveAvgPool2D: counterparts of
paddle_tpu/nn/pooling.py, over `ops.nn_ops`."""
from __future__ import annotations

from torch import nn

from ..ops.nn_ops import adaptive_avg_pool2d, max_pool2d

__all__ = ["MaxPool2D", "AdaptiveAvgPool2D"]


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return max_pool2d(x, self.kernel_size, self.stride, self.padding)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return adaptive_avg_pool2d(x, self.output_size)
