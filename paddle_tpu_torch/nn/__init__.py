"""Layers and helpers of the port outside the models: gradient clipping,
the conv layers a ResNet is built from, BatchNorm folding and the
Transformer layers."""
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .conv import Conv2D
from .fused import ConvBNReLU, fold_bn_into_conv, fuse_conv_bn
from .norm import BatchNorm2D
from .pooling import AdaptiveAvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "Conv2D", "BatchNorm2D", "MaxPool2D", "AdaptiveAvgPool2D",
           "ConvBNReLU", "fold_bn_into_conv", "fuse_conv_bn",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]
