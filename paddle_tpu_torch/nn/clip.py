"""Gradient clipping: counterpart of paddle_tpu/nn/clip.py (analog of
python/paddle/fluid/clip.py). An optimizer calls its `grad_clip` on the
list of (param, grad) pairs before the update. Norms are taken in fp32;
each clipped grad is cast back to its own dtype.
"""
from __future__ import annotations

import torch

from ..core.tensor import plain

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads):
        """[(param, grad or None)] -> the same pairs, grads clipped."""
        grads = self._clip([plain(g) for _, g in params_grads])
        return [(p, g) for (p, _), g in zip(params_grads, grads)]

    def _clip(self, grads):
        """The clipped grads, None entries passed through."""
        raise NotImplementedError


def _sq_norm(g):
    return torch.sum(torch.square(g.float()))


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, grads):
        return [None if g is None else torch.clamp(g, self.min, self.max)
                for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Each grad on its own: scaled by min(clip_norm / ||g||, 1)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, grads):
        out = []
        for g in grads:
            if g is None:
                out.append(None)
                continue
            norm = torch.sqrt(_sq_norm(g))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((g.float() * scale).to(g.dtype))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All grads together: scaled by clip_norm / max(global norm,
    clip_norm). `group_name` is kept and has no effect on one device, as in
    the JAX package."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip(self, grads):
        sq = [_sq_norm(g) for g in grads if g is not None]
        if not sq:
            return grads
        global_norm = torch.sqrt(torch.stack(sq).sum())
        scale = self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)
        return [None if g is None else (g.float() * scale).to(g.dtype)
                for g in grads]
