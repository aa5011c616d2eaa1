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
  core (`async_core=True`), and `TrainStep(telemetry=)`.
"""
from . import amp, distributed, observability, optimizer, profiler, vision
from .device import resolve_device
from .inference.engine import GenerationEngine, PagedKVCache, Request
from .jit import TrainStep
from .models.bert import (BertConfig, BertForPretraining,
                          BertForSequenceClassification, BertModel,
                          ErnieModel)
from .models.convert import load_paddle_tpu_state, paddle_tpu_state
from .models.gpt import GPTConfig, GPTForCausalLM
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
           "resnet152"]
