"""paddle.save / paddle.load: counterpart of paddle_tpu/framework/io.py.

A pickle of nested state with every tensor as a numpy array; bfloat16
(which numpy lacks) as `{"__paddle_tpu_bf16__": True, "data": uint16
view}`, the JAX package's tag, so a file written by either package loads
in the other, bf16 bit for bit. `save` takes the port's `Tensor`s and
plain torch tensors (a model's `state_dict()`); `load` gives `Tensor`s on
the selected place, or the pickled numpy state with `return_numpy=True`.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

_BF16_TAG = "__paddle_tpu_bf16__"


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().as_subclass(torch.Tensor)
        if t.dtype == torch.bfloat16:
            return {_BF16_TAG: True,
                    "data": t.view(torch.int16).numpy().view(np.uint16)}
        return t.numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _from_host(obj):
    from ..core.tensor import Tensor

    if isinstance(obj, dict):
        if obj.get(_BF16_TAG):
            bits = torch.from_numpy(np.ascontiguousarray(
                obj["data"]).view(np.int16))
            return Tensor(bits.view(torch.bfloat16))
        return {k: _from_host(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return Tensor(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_host(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_host(obj), f, protocol=protocol)


def load(path, **configs):
    with open(path, "rb") as f:
        obj = pickle.load(f)
    if configs.get("return_numpy"):
        return obj
    return _from_host(obj)
