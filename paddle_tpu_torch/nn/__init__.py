"""Layers and helpers of the port outside the models: gradient clipping,
the conv layers a ResNet is built from, BatchNorm folding, the loss layers
and the Transformer layers; `functional`, the paddle API's
nn.functional."""
from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .conv import Conv2D
from .fused import ConvBNReLU, fold_bn_into_conv, fuse_conv_bn
from .loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss,
                   HingeEmbeddingLoss, KLDivLoss, L1Loss, MarginRankingLoss,
                   MSELoss, NLLLoss, SmoothL1Loss)
from .norm import BatchNorm2D
from .pooling import AdaptiveAvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "Conv2D", "BatchNorm2D", "MaxPool2D", "AdaptiveAvgPool2D",
           "ConvBNReLU", "fold_bn_into_conv", "fuse_conv_bn",
           "CrossEntropyLoss", "MSELoss", "L1Loss", "SmoothL1Loss",
           "NLLLoss", "BCELoss", "BCEWithLogitsLoss", "KLDivLoss",
           "MarginRankingLoss", "HingeEmbeddingLoss",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "functional"]
