"""Autograd-correct dtype casts for AMP autocast: counterpart of
paddle_tpu/amp/cast_helper.py."""
from __future__ import annotations

import torch


def cast_tensor_list(inputs, to_dtype):
    """Cast the floating tensors of `inputs` to `to_dtype` through the
    tracked op `amp_cast`, so gradients come back in the original
    dtype."""
    from ..ops.dispatch import apply

    out = []
    for t in inputs:
        if (isinstance(t, torch.Tensor) and t.dtype.is_floating_point
                and t.dtype != to_dtype):
            out.append(apply("amp_cast", lambda a: a.to(to_dtype), t))
        else:
            out.append(t)
    return out
