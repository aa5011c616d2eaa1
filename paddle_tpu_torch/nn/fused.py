"""ConvBNReLU and BatchNorm folding: counterpart of paddle_tpu/nn/fused.py.

`ConvBNReLU` is the block `vision/models/resnet.py` builds from: a Conv2D
(no bias) + BatchNorm2D (+ optional ReLU) whose eval forward on the kernel
route is ONE fused kernel (`ops.conv.fused_conv_bn_relu`): the BatchNorm
affine folded to an fp32 scale and shift, applied with the ReLU in
registers before the one store. Its training forward on the kernel route
is `ops.conv.fused_conv_bn_relu_train` (the conv with the batch
statistics in the kernel's epilogue, and a backward through the 1x1
backward, 3x3 dWeight and 3x3 dInput kernels), with the running-stat
update of `batch_norm`. The backend (`auto`/`dense`/`pallas`) is resolved
once, at construction. The dense backend, a folded block and a BatchNorm
with `use_global_stats` run the composition conv -> BatchNorm -> ReLU,
counted in `fused_conv_bn_relu.dense_calls` in eval and
`fused_conv_bn_relu.dense_train_calls` in training (JAX's "dense" and
"dense_train").

There is no per-call geometry gate on either route. JAX checks
`conv_geometry_tileable` / `conv_train_geometry_tileable` on every forward
and runs the composition where the TPU walk cannot tile; those are TPU
limits (VMEM slabs, the 16-tile unroll bound) the CUDA kernels do not
have, so every shape the static gate accepts takes the kernels here.

Parameter names match the JAX block's: `conv.weight`, `bn.weight`,
`bn.bias` and the buffers `bn._mean`, `bn._variance`.

`fold_bn_into_conv` / `fuse_conv_bn` are the deploy-time counterpart: the
running-stat affine folded into the conv's weight and bias (in fp64 on the
host), so the eval forward skips the BatchNorm.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.conv import (fused_conv_bn_relu, fused_conv_bn_relu_train,
                        resolve_conv_backend)
from ..ops.nn_ops import update_running_stats
from .conv import Conv2D
from .norm import BatchNorm2D

__all__ = ["ConvBNReLU", "fold_bn_into_conv", "fuse_conv_bn"]


class ConvBNReLU(nn.Module):
    """Conv2D + BatchNorm2D + optional ReLU with a fused-kernel eval path.

    `act` is "relu" or None (the bn3 / downsample shape). `backend` is
    `auto`/`dense`/`pallas` (default auto), resolved once here
    (`resolve_conv_backend`): shapes the kernels do not take (the 7x7/s2
    stem, grouped or dilated convs, channels not a multiple of 8) resolve
    `dense` whatever was asked, and so does a custom `norm_layer` (no
    affine to fold). `norm_layer` is called with the channel count and
    moved to `device` and `dtype`. `device`, `dtype` and `generator` as
    `Conv2D` takes them.

    On the kernel route the input goes to `torch.channels_last` memory
    (free when it is there already: ResNet keeps its activations so), so
    that its NHWC view is contiguous; the output is the kernel's NHWC
    tensor viewed back as NCHW, channels_last in memory."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, act="relu", backend=None,
                 norm_layer=None, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        if act not in ("relu", None):
            raise ValueError(f"act must be 'relu' or None, got {act!r}")
        self.conv = Conv2D(in_channels, out_channels, kernel_size,
                           stride=stride, padding=padding, dilation=dilation,
                           groups=groups, bias_attr=False, device=device,
                           dtype=dtype, generator=generator)
        if norm_layer is None:
            self.bn = BatchNorm2D(out_channels, device=device, dtype=dtype)
        else:
            self.bn = norm_layer(out_channels).to(device=device, dtype=dtype)
        self._act = act
        self._folded = False
        self.backend = resolve_conv_backend(
            backend, kernel=self.conv._kernel_size, stride=self.conv._stride,
            in_channels=in_channels, out_channels=out_channels,
            dilation=self.conv._dilation, groups=groups, padding=padding)
        if not isinstance(self.bn, BatchNorm2D):
            self.backend = "dense"

    def extra_repr(self):
        return (f"{self.conv._in_channels}, {self.conv._out_channels}, "
                f"kernel_size={self.conv._kernel_size}, "
                f"stride={self.conv._stride}, act={self._act!r}, "
                f"backend={self.backend}")

    def forward(self, x):
        if self.backend == "pallas" and not self._folded:
            if not self.training:
                return self._forward_fused(x)
            if not self.bn._use_global_stats:
                return self._forward_fused_train(x)
        return self._compose(x)

    def _compose(self, x):
        """The dense route: conv -> BatchNorm (unless folded) -> ReLU."""
        if self.training:
            fused_conv_bn_relu.dense_train_calls += 1
        else:
            fused_conv_bn_relu.dense_calls += 1
        out = self.conv(x)
        if not self._folded:
            out = self.bn(out)
        if self._act == "relu":
            out = torch.relu(out)
        return out

    @torch.no_grad()
    def _forward_fused(self, x):
        """One kernel: scale = gamma * rsqrt(var + eps) and shift = beta -
        mean * scale in fp32 from the parameters' own dtype, the weight to
        HWIO, `fused_conv_bn_relu` on the NHWC view. Forward only, as in
        JAX: the output carries no gradient."""
        bn = self.bn
        scale = bn.weight.float() * torch.rsqrt(bn._variance.float()
                                                + bn._epsilon)
        shift = bn.bias.float() - bn._mean.float() * scale
        xh = x.contiguous(memory_format=torch.channels_last) \
            .permute(0, 2, 3, 1)
        w = self.conv.weight.permute(2, 3, 1, 0).contiguous()   # OIHW -> HWIO
        out = fused_conv_bn_relu(xh, w, scale, shift,
                                 stride=self.conv._stride,
                                 padding=self.conv._padding,
                                 relu=self._act == "relu")
        return out.permute(0, 3, 1, 2)

    def _forward_fused_train(self, x):
        """One differentiable op: the NHWC view of the channels_last input
        and the weight in HWIO (a differentiable copy) through
        `fused_conv_bn_relu_train`, the output viewed back as NCHW. The
        running statistics update in place from the returned batch mean
        and var with `batch_norm`'s rule (unbiased var over N*Ho*Wo,
        `momentum`)."""
        bn = self.bn
        xh = x.contiguous(memory_format=torch.channels_last) \
            .permute(0, 2, 3, 1)
        w = self.conv.weight.permute(2, 3, 1, 0).contiguous()   # OIHW -> HWIO
        y, mean, var = fused_conv_bn_relu_train(
            xh, w, bn.weight, bn.bias, stride=self.conv._stride,
            padding=self.conv._padding, relu=self._act == "relu",
            eps=bn._epsilon)
        update_running_stats(bn._mean, bn._variance, mean, var,
                             y.numel() // y.shape[3], bn._momentum)
        return y.permute(0, 3, 1, 2)

    def fold(self):
        """Inference-time folding: the running-stat affine absorbed into the
        conv's weight and bias, the BatchNorm dropped from forward (which
        then takes the composition route). Idempotent; switches to eval
        mode, since training a folded conv against a dead BatchNorm is
        meaningless."""
        if self._folded:
            return self
        fold_bn_into_conv(self.conv, self.bn)
        self._folded = True
        self.eval()
        return self


@torch.no_grad()
def fold_bn_into_conv(conv, bn):
    """Fold an eval-mode BatchNorm's affine into `conv` in place:
    w' = w * scale per output channel, b' = beta - mean * scale (+ the old
    bias * scale), scale = gamma / sqrt(var + eps), all in fp64 on the
    host, then cast once to the weight's dtype. A conv without a bias gets
    one."""
    def host(t):
        return t.detach().to("cpu", torch.float64)

    w = host(conv.weight)
    scale = host(bn.weight) / torch.sqrt(host(bn._variance) + bn._epsilon)
    shift = host(bn.bias) - host(bn._mean) * scale
    if conv.bias is not None:
        shift = shift + host(conv.bias) * scale
    dt, dev = conv.weight.dtype, conv.weight.device
    conv.weight.copy_((w * scale[:, None, None, None]).to(dev, dt))
    if conv.bias is None:
        conv.bias = nn.Parameter(torch.empty(conv._out_channels, device=dev,
                                             dtype=dt))
    conv.bias.copy_(shift.to(dev, dt))
    return conv


def fuse_conv_bn(layer):
    """Walk a module tree and fold every foldable BatchNorm for eval:
    `ConvBNReLU` blocks fold in place, and a (Conv2D, BatchNorm2D) pair
    adjacent in a module's children order (the `conv1`/`bn1` stem) folds
    into the conv, the BatchNorm replaced by `nn.Identity`. Returns the
    number of BatchNorms folded. Call it on an eval-mode model whose
    forward applies each such BatchNorm straight to its conv's output."""
    n = 0
    if isinstance(layer, ConvBNReLU):
        if not layer._folded and isinstance(layer.bn, BatchNorm2D):
            layer.fold()
            n += 1
        return n
    prev = None
    for name, sub in list(layer.named_children()):
        if isinstance(sub, BatchNorm2D) and isinstance(prev, Conv2D):
            fold_bn_into_conv(prev, sub)
            setattr(layer, name, nn.Identity())
            prev = None
            n += 1
            continue
        n += fuse_conv_bn(sub)
        prev = sub
    return n
