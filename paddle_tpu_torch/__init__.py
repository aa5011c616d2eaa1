"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package `paddle_tpu` stays the reference; this package grows beside
it slice by slice. It imports torch and numpy only, never jax and nothing of
`paddle_tpu`. Each TPU kernel on a ported path is a hand-written CUDA kernel
for sm_90a under `csrc/`, built with nvcc at first use; its wrapper takes the
plain PyTorch version for a CPU tensor and launches the kernel (or raises)
for a CUDA tensor.

Ported so far:
- greedy serving of the GPT through the paged engine
  (`inference.GenerationEngine` over `models.GPTForCausalLM`), with the
  paged decode kernel (`ops.paged_decode`) and the causal attention
  forward (`ops.flash_attention`);
- training of the GPT: `jit.TrainStep` over the model's loss, AdamW or
  Adam (`optimizer`), LR schedulers (`optimizer.lr`) and gradient
  clipping (`nn`), with the causal attention backward kernel;
- the rest of training's surface: gradient merge
  (`TrainStep(accumulate_steps=)`), loss scaling (`amp.GradScaler`, eager
  and inside `TrainStep(scaler=)`), `with_outputs`, a model that returns
  its own loss, and SGD, Adagrad, RMSProp, Adadelta, Lars and Lamb, with
  the merge, unscale and norm kernels (`ops.grad_merge`,
  `ops.optimizer_update`);
- speculative decoding (`spec_decode_k`) and int8 KV pools on the engine,
  with the paged verify kernel and the int8 paged kernels;
- the encoder path: BERT/ERNIE (`models.bert`) through
  `BertForSequenceClassification` and `BertForPretraining`, trained
  through `TrainStep`, with the short-sequence attention forward and
  backward kernels, mask-free and key-masked (`ops.flash_attention`);
- ResNet eval inference (`vision.models.resnet50` and the other depths),
  built from `nn.ConvBNReLU`, with the fused 1x1 and 3x3 conv+BN+ReLU
  kernels (`ops.conv`);
- ResNet training through `TrainStep` with `Momentum`: BatchNorm's
  training form, and `ConvBNReLU`'s train route through
  `ops.conv.fused_conv_bn_relu_train`, with the conv train-forward
  kernels (batch statistics in the epilogue), the 1x1 backward and the
  3x3 dWeight kernels;
- inference of the encoder-decoder Transformer (`nn.Transformer` and its
  layers), whose encoder self-attention over long sources and decoder
  cross-attention take the flash forward kernel B6
  (`ops.flash_attention.sdpa_forward`, also behind `pallas_sdpa_forward`);
- every loss of the JAX package (`ops.nn_ops`, the layers in `nn`);
- sampled serving (`GenerationEngine(sampling=True)`,
  `inference.SamplingParams`, `best_of_n`) on jax's own threefry keys and
  bits (`ops.threefry`), with the draw kernels (`ops.sampling`), and int8
  weights (`weight_dtype="int8"`, `quantization`) through the int8-weight
  linear kernel (`ops.int8_linear`);
- bucketed prefill (`GenerationEngine(prefill_chunk=None)` or
  `prefill_buckets=`) through the causal attention forward, and
  multi-tenant LoRA serving (`adapters`: the registry and the paged pool;
  `GenerationEngine(adapters=)`, `add_request(adapter_id=)`) with the
  batched LoRA kernel (`ops.lora`);
- tensor-parallel serving (`GenerationEngine(mp_degree=N)`, `mesh=` a
  `distributed.serving_mesh`, `PADDLE_SERVE_MP`): head-sharded paged pools
  and a column-parallel weight snapshot under one scheduler, each shard
  running the kernels above at its shapes;
- the observability tier (`observability`: the metrics registry, the
  Prometheus exposition and server, request tracing, the flight recorder,
  `TrainingTelemetry`) and the profiler's host half (`profiler`); the
  engine's metrics, tracing and flight recorder, its dispatch-ahead async
  core (`async_core=True`), and `TrainStep(telemetry=)`;
- the paddle API that user code is written against (`core`, `autograd`,
  `ops.creation`, `ops.math`, `ops.manipulation`, `ops.reduction`,
  `ops.activation`, `ops.random_ops`): `Tensor` (a `torch.Tensor`
  subclass) and `Parameter`, `to_tensor`, `stop_gradient`, `.backward()`,
  `grad`, `PyLayer`, `seed` (jax's key chain and bits), `set_device`
  ('gpu' or 'cpu'), and the ops of the six modules under the JAX
  package's top-level names;
- the `nn` layers (`nn.Layer`, a `torch.nn.Module` with JAX's surface,
  `ParamAttr`, the initializers of `nn.initializer` on jax's key chain,
  and every layer class of JAX's `nn`, from `Linear` to `LSTM`) and the
  `paddle.device` package (places, `synchronize`, memory statistics).
"""
from . import amp, distributed, observability, optimizer, profiler, vision
from . import autograd, core, ops
from .core import (Parameter, Tensor, enable_grad, get_default_dtype,
                   get_device, grad, no_grad, seed, set_default_dtype,
                   set_device)
from .core.pylayer import PyLayer
from .core.random import get_rng_state, set_rng_state
from . import device  # noqa: E402
from .device import resolve_device
from .ops.activation import (  # noqa: F401
    celu, elu, gelu, glu, gumbel_softmax, hardshrink, hardsigmoid,
    hardswish, hardtanh, leaky_relu, log_sigmoid, log_softmax, maxout, mish,
    prelu, relu, relu6, rrelu, selu, sigmoid, silu, softmax, softplus,
    softshrink, softsign, swish, tanhshrink, thresholded_relu)
from .ops.creation import (  # noqa: F401
    arange, complex, diag, diagflat, empty, empty_like, eye, full, full_like,
    linspace, logspace, meshgrid, one_hot, ones, ones_like, to_tensor, tril,
    triu, vander, zeros, zeros_like)
from .ops.manipulation import (  # noqa: F401
    as_complex, as_real, as_strided, broadcast_to, bucketize, chunk, clone,
    concat, crop, diff, dsplit, expand, expand_as, flatten, flip, gather,
    gather_nd, hsplit, index_select, masked_select, moveaxis, numel,
    put_along_axis, repeat_interleave, reshape, roll, rot90, scatter,
    scatter_nd, searchsorted, slice, split, squeeze, stack, strided_slice,
    swapaxes, swapdims, take, take_along_axis, tensordot, tile, transpose,
    unbind, unsqueeze, unstack, vsplit)
from .ops.math import (  # noqa: F401
    abs, add, addmm, allclose, angle, atan2, cast, ceil, clip, conj,
    copysign, cos, cosh, digamma, divide, equal, equal_all, erf, erfinv,
    exp, expm1, float_power, floor, floor_divide, fmax, fmin, fmod, frac,
    greater_equal, greater_than, heaviside, hypot, i0, imag, increment,
    isclose, isfinite, isinf, isnan, lerp, less_equal, less_than, lgamma,
    log, log1p, log2, log10, logaddexp, logical_and, logical_not, logical_or,
    logical_xor, logit, maximum, minimum, mod, multiplex, multiply,
    multiply_, nan_to_num, neg, nextafter, not_equal, polygamma, pow, real,
    reciprocal, remainder, round, rsqrt, scale, sgn, sign, signbit, sin,
    sinc, sinh, sqrt, square, subtract, tan, tanh, true_divide, trunc, where)
from .ops.linalg import (  # noqa: F401
    baddbmm, bmm, corrcoef, cov, cross, det, diagonal, dist, dot, eigh,
    einsum, histogram, inner, inverse, kron, matmul, mm, mv, norm, outer,
    pinv, qr, renorm, slogdet, solve, svd, t, trace)
from .ops import tensor_methods  # noqa: F401  (installs the methods)
from .ops.random_ops import (  # noqa: F401
    bernoulli, multinomial, normal, poisson, rand, randint, randint_like,
    randn, randperm, shuffle, standard_normal, uniform)
from .ops.reduction import (  # noqa: F401
    all, amax, amin, any, argmax, argmin, argsort, bincount, count_nonzero,
    cumprod, cumsum, kthvalue, logsumexp, max, mean, median, min, mode,
    nanmean, nanmedian, nansum, nonzero, prod, quantile, sort, std, sum,
    topk, trapezoid, unique, var)
from . import framework, linalg  # noqa: E402
from .framework import get_flags, load, save, set_flags  # noqa: E402
from .inference.engine import GenerationEngine, PagedKVCache, Request
from .jit import TrainStep
from .models.bert import (BertConfig, BertForPretraining,
                          BertForSequenceClassification, BertModel,
                          ErnieModel)
from .models.convert import load_paddle_tpu_state, paddle_tpu_state
from .models.gpt import GPTConfig, GPTForCausalLM
from . import nn  # noqa: E402
from .nn import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                 MultiHeadAttention, Transformer, TransformerDecoder,
                 TransformerDecoderLayer, TransformerEncoder,
                 TransformerEncoderLayer)
from .optimizer import (SGD, Adadelta, Adagrad, Adam, AdamW, Lamb, Lars,
                        Momentum, RMSProp)
from .vision.models import resnet18, resnet34, resnet50, resnet101, resnet152

__all__ = ["resolve_device", "GenerationEngine", "PagedKVCache", "Request",
           "GPTConfig", "GPTForCausalLM", "BertConfig", "BertModel",
           "ErnieModel", "BertForSequenceClassification",
           "BertForPretraining", "load_paddle_tpu_state",
           "paddle_tpu_state", "TrainStep", "SGD", "Momentum", "Adam",
           "AdamW", "Adagrad", "RMSProp", "Adadelta", "Lars", "Lamb",
           "optimizer", "amp", "distributed",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer",
           "vision", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "core", "autograd", "ops", "Tensor", "Parameter",
           "PyLayer", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "seed", "get_rng_state", "set_rng_state", "set_device",
           "get_device", "get_default_dtype", "set_default_dtype",
           "in_dynamic_mode", "framework", "linalg", "save", "load",
           "set_flags", "get_flags", "nn", "device"]


def is_grad_enabled():
    return core.autograd.is_grad_enabled()


def in_dynamic_mode():
    return True


bfloat16 = "bfloat16"
float16 = "float16"
float32 = "float32"
float64 = "float64"
int8 = "int8"
int16 = "int16"
int32 = "int32"
int64 = "int64"
uint8 = "uint8"
bool = "bool"
complex64 = "complex64"
