"""paddle.nn of the port: counterpart of paddle_tpu/nn (python/paddle/nn/).

`Layer` and `ParamAttr` (`nn.layer`), the initializers
(`nn.initializer`), the layers of `common`, `container`,
`activation_layers`, `norm`, `pooling`, `conv` and `rnn` over the op
dispatch (`functional`, also `F`), the conv block and BatchNorm folding
(`fused`), the loss layers, the gradient clips and the Transformer
layers."""
from . import functional, initializer
from .activation_layers import (
    CELU, ELU, GELU, SELU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    Sigmoid, Silu, Softmax, Softplus, Softshrink, Softsign, Swish, Tanh,
    Tanhshrink,
)
from .common import (
    CosineSimilarity, Dropout, Dropout2D, Embedding, Flatten, Fold, Identity,
    Linear, Pad2D, PixelShuffle, Unfold, Upsample,
)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import Conv1D, Conv2D, Conv2DTranspose, Conv3D
from .rnn import (GRU, LSTM, RNN, GRUCell, LSTMCell, SimpleRNN,
                  SimpleRNNCell)
from .layer import Layer, ParamAttr
from .loss import (
    BCELoss, BCEWithLogitsLoss, CrossEntropyLoss, HingeEmbeddingLoss,
    KLDivLoss, L1Loss, MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
)
from .norm import (
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm2D, LayerNorm, LocalResponseNorm, RMSNorm, SpectralNorm,
    SyncBatchNorm,
)
from .fused import ConvBNReLU, fold_bn_into_conv, fuse_conv_bn
from .pooling import (
    AdaptiveAvgPool2D, AdaptiveMaxPool2D, AvgPool1D, AvgPool2D, AvgPool3D,
    MaxPool1D, MaxPool2D, MaxPool3D,
)
from .transformer import (
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from . import (activation_layers, common, container, layer,  # noqa: F401
               rnn)

F = functional
