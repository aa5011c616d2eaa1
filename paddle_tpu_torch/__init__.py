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
- speculative decoding (`spec_decode_k`) and int8 KV pools on the engine,
  with the paged verify kernel and the int8 paged kernels;
- the encoder path: BERT/ERNIE (`models.bert`) through
  `BertForSequenceClassification` and `BertForPretraining`, trained
  through `TrainStep`, with the short-sequence attention forward and
  backward kernels, mask-free and key-masked (`ops.flash_attention`);
- ResNet eval inference (`vision.models.resnet50` and the other depths),
  built from `nn.ConvBNReLU`, with the fused 1x1 and 3x3 conv+BN+ReLU
  kernels (`ops.conv`).
"""
from . import optimizer, vision
from .device import resolve_device
from .inference.engine import GenerationEngine, PagedKVCache, Request
from .jit import TrainStep
from .models.bert import (BertConfig, BertForPretraining,
                          BertForSequenceClassification, BertModel,
                          ErnieModel)
from .models.convert import load_paddle_tpu_state, paddle_tpu_state
from .models.gpt import GPTConfig, GPTForCausalLM
from .nn import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .optimizer import Adam, AdamW
from .vision.models import resnet18, resnet34, resnet50, resnet101, resnet152

__all__ = ["resolve_device", "GenerationEngine", "PagedKVCache", "Request",
           "GPTConfig", "GPTForCausalLM", "BertConfig", "BertModel",
           "ErnieModel", "BertForSequenceClassification",
           "BertForPretraining", "load_paddle_tpu_state",
           "paddle_tpu_state", "TrainStep", "Adam", "AdamW", "optimizer",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "vision", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152"]
