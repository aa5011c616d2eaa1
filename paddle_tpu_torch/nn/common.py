"""Common layers: counterpart of paddle_tpu/nn/common.py
(python/paddle/nn/layer/common.py), each over the port's functional ops
(`ops.nn_ops`, `ops.manipulation`: the op dispatch, so each counts in
`OpStats` under JAX's names and casts under `amp.auto_cast`). `Linear`
keeps paddle's weight `[in, out]`.

The port's own keywords, `device` and `dtype`, come last and keyword-only
on the layers with parameters (`Layer` explains where parameters land)."""
from __future__ import annotations

import torch

from ..ops import manipulation as mp
from ..ops import nn_ops
from . import initializer as I

from .layer import Layer


class Linear(Layer):
    """y = xW + b, weight [in_features, out_features] (paddle layout).
    Analog of paddle.nn.Linear (python/paddle/nn/layer/common.py)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype or "float32")
        self._place = device
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr)
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return nn_ops.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return nn_ops.dropout(x, self.p, training=self.training,
                              mode=self.mode, axis=self.axis)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return nn_ops.dropout2d(x, self.p, training=self.training,
                                data_format=self.data_format)


class Embedding(Layer):
    """Analog of paddle.nn.Embedding: a gather of rows of the weight
    `[num_embeddings, embedding_dim]`, N(0, 1) at init; the row at
    `padding_idx` is zero."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype or "float32")
        self._place = device
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return nn_ops.embedding(x, self.weight, padding_idx=self._padding_idx)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return mp.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.data_format = data_format

    def forward(self, x):
        return nn_ops.interpolate(x, self.size, self.scale_factor, self.mode,
                                  self.align_corners, self.data_format)


class Pad2D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return mp.pad(x, self.padding, self.mode, self.value, self.data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW"):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return nn_ops.pixel_shuffle(x, self.upscale_factor)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return nn_ops.cosine_similarity(x1, x2, self.axis, self.eps)


class Unfold(Layer):
    """im2col layer (python/paddle/nn/layer/common.py Unfold)."""

    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes, self.strides = kernel_sizes, strides
        self.paddings, self.dilations = paddings, dilations

    def forward(self, x):
        return nn_ops.unfold(x, self.kernel_sizes, self.strides,
                             self.paddings, self.dilations)


class Fold(Layer):
    """col2im layer (common.py Fold) — the exact adjoint of Unfold."""

    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes, self.kernel_sizes = output_sizes, kernel_sizes
        self.strides, self.paddings, self.dilations = \
            strides, paddings, dilations

    def forward(self, x):
        return nn_ops.fold(x, self.output_sizes, self.kernel_sizes,
                           self.strides, self.paddings, self.dilations)
