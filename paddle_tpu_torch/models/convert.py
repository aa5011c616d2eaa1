"""Weight bridge between the JAX package's models and the port's: the GPT,
BERT (both heads), the ResNets and the Transformer family
(`nn.Transformer`, its encoder and decoder stacks and layers,
`MultiHeadAttention`).

The input is the JAX model's `state_dict()` (paddle_tpu/nn/layer.py) as
numpy arrays under the same names: its parameters and its persistable
buffers (BatchNorm's `_mean` and `_variance`), which the port's parameters
and persistent buffers match one to one. Paddle's `Linear` keeps its
weight `[in, out]` (paddle_tpu/nn/common.py); torch's is `[out, in]`, so
those transpose; conv weights (OIHW in both), embeddings and every other
entry do not. A tied weight appears once, under its owner's name: the
GPT's LM head reads `gpt.wte.weight`, and BERT's pretraining decoder
`bert.embeddings.word_embeddings.weight` (neither state_dict has a name of
its own for the tied side).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["load_paddle_tpu_state", "paddle_tpu_state"]


def _linear_weights(model):
    return {f"{name}.weight" for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


def _entries(model):
    """{name: tensor} of the parameters (each shared one once) and the
    persistent buffers: the entries of the JAX model's state_dict."""
    out = dict(model.named_parameters())
    persistent = model.state_dict(keep_vars=True)
    out.update((n, b) for n, b in model.named_buffers() if n in persistent)
    return out


@torch.no_grad()
def load_paddle_tpu_state(model, arrays):
    """Copy `arrays` ({JAX state_dict name: np.ndarray}) into `model`'s
    parameters and persistent buffers, transposing Linear weights and
    casting to each entry's dtype. A name on either side that the other
    lacks, or a shape that does not match, raises."""
    params = _entries(model)
    missing = sorted(set(params) - set(arrays))
    unused = sorted(set(arrays) - set(params))
    if missing or unused:
        raise KeyError(f"weight bridge mismatch: missing {missing}, "
                       f"unused {unused}")
    linear = _linear_weights(model)
    for name, p in params.items():
        a = np.asarray(arrays[name]).astype(np.float32)
        if name in linear:
            a = a.T
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape} does not fit the "
                             f"port's {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return model


def paddle_tpu_state(model):
    """The inverse: {JAX state_dict name: float32 np.ndarray} in the JAX
    package's layout (Linear weights `[in, out]`), buffers included."""
    linear = _linear_weights(model)
    out = {}
    for name, p in _entries(model).items():
        a = p.detach().float().cpu().numpy()
        out[name] = np.ascontiguousarray(a.T if name in linear else a)
    return out
