"""ResNet: counterpart of paddle_tpu/vision/models/resnet.py (the
PaddleClas ResNet-50 benchmark configuration).

NCHW at the API, with the activations kept in `torch.channels_last`
memory from the input on: the residual blocks are `ConvBNReLU` blocks
whose kernel route reads and writes NHWC (`nn/fused.py`), and torch's
convolution, BatchNorm arithmetic, pooling, ReLU and residual add all keep
channels_last, so no activation is transposed between layers. The blocks
take the `conv_backend` seam (`auto`/`dense`/`pallas`): in eval on the
kernel route every bottleneck and downsample conv+BN+ReLU is one fused
kernel (52 in a ResNet-50: 36 1x1 and 16 3x3). The 7x7/s2 stem stays a
plain Conv2D and BatchNorm2D pair, as in JAX. JAX computes the stem conv
through a space-to-depth repacking that feeds a TPU's 128-lane matrix unit
better; it is the same convolution, which the port computes with
`F.conv2d`. Parameter and buffer names match the JAX model's
`state_dict()` (`models/convert.py` bridges them).

`device=None` means the CUDA card and raises without one; pass
`device="cpu"` to run the plain versions of the kernels on the CPU.
Weights are drawn from `generator` (a `torch.Generator` on the device;
seed 0 when None) with the JAX package's init scheme: KaimingUniform
convs, unit BatchNorm weights, zero biases and running statistics at
(0, 1), a Xavier-normal `fc`.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core.tensor import plain_entry
from ...device import resolve_device
from ...nn.conv import Conv2D
from ...nn.fused import ConvBNReLU
from ...nn.norm import BatchNorm2D
from ...nn.pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152"]

_LAYERS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
           101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 conv_backend=None, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.convbn1 = ConvBNReLU(inplanes, planes, 3, stride=stride,
                                  padding=1, act="relu",
                                  backend=conv_backend,
                                  norm_layer=norm_layer, **kw)
        self.convbn2 = ConvBNReLU(planes, planes, 3, padding=1, act=None,
                                  backend=conv_backend,
                                  norm_layer=norm_layer, **kw)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.convbn2(self.convbn1(x)) + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 conv_backend=None, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        width = int(planes * (base_width / 64.0)) * groups
        self.convbn1 = ConvBNReLU(inplanes, width, 1, act="relu",
                                  backend=conv_backend,
                                  norm_layer=norm_layer, **kw)
        self.convbn2 = ConvBNReLU(width, width, 3, stride=stride,
                                  padding=dilation, dilation=dilation,
                                  groups=groups, act="relu",
                                  backend=conv_backend,
                                  norm_layer=norm_layer, **kw)
        self.convbn3 = ConvBNReLU(width, planes * self.expansion, 1,
                                  act=None, backend=conv_backend,
                                  norm_layer=norm_layer, **kw)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.convbn3(self.convbn2(self.convbn1(x)))
        return torch.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, conv_backend=None, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        kw = dict(device=self.device, dtype=dtype, generator=generator)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._conv_backend = conv_backend
        self.inplanes = 64
        # children in the JAX model's order: fuse_conv_bn folds the
        # adjacent conv1/bn1 pair
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, **kw)
        self.bn1 = BatchNorm2D(self.inplanes, device=self.device,
                               dtype=dtype)
        self.relu = nn.ReLU()
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        layers = _LAYERS[depth]
        self.layer1 = self._make_layer(block, 64, layers[0], kw)
        self.layer2 = self._make_layer(block, 128, layers[1], kw, stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], kw, stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], kw, stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                device=self.device, dtype=dtype)
            with torch.no_grad():
                std = math.sqrt(2.0 / (self.fc.in_features
                                       + self.fc.out_features))
                self.fc.weight.normal_(0.0, std, generator=generator)
                self.fc.bias.zero_()

    def _make_layer(self, block, planes, blocks, kw, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            # the 1x1/s projection shortcut: a fused-kernel shape too
            downsample = ConvBNReLU(self.inplanes, planes * block.expansion,
                                    1, stride=stride, act=None,
                                    backend=self._conv_backend, **kw)
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width,
                        conv_backend=self._conv_backend, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                conv_backend=self._conv_backend, **kw))
        return nn.Sequential(*layers)

    @plain_entry('ResNet')
    def forward(self, x):
        """`[B, 3, H, W]` -> logits `[B, num_classes]` (or the pooled or
        unpooled features without a head), in the parameters' dtype."""
        x = x.contiguous(memory_format=torch.channels_last)
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def resnet18(**kwargs):
    return ResNet(BasicBlock, 18, **kwargs)


def resnet34(**kwargs):
    return ResNet(BasicBlock, 34, **kwargs)


def resnet50(**kwargs):
    return ResNet(BottleneckBlock, 50, **kwargs)


def resnet101(**kwargs):
    return ResNet(BottleneckBlock, 101, **kwargs)


def resnet152(**kwargs):
    return ResNet(BottleneckBlock, 152, **kwargs)
