"""Per-request sampling parameters for the generation engine: counterpart
of paddle_tpu/inference/sampling.py (the device half is `ops/sampling.py`).

`SamplingParams(temperature, top_k, top_p, seed)` rides a request through
`GenerationEngine.add_request` and is carried per slot into the decode,
verify and prefill steps as per-row tensors. Every sampled request owns one
integer seed (explicit, or assigned from the engine's deterministic counter
when None); `key_row` turns it into the slot's base key, and each draw
folds the slot's absolute position and a draw-purpose salt into it, so the
token at position P+1 is drawn with the key folded from P whatever path
produced it. The keys are jax's threefry keys (`ops/threefry.py`), so a
stream is the JAX engine's token for token where the logits agree.

`oracle_probs` is the numpy reference of the masked sampling distribution,
an implementation apart from `ops/sampling.py`, which the statistical tests
hold the draws to. `SamplingParams` and `oracle_probs` are copied from the
JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.threefry import M32, fold_in

__all__ = ["SamplingParams", "key_row", "oracle_probs"]


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs.

    temperature: 0 = greedy (argmax — bit-identical to a no-sampling
      engine, whatever the other knobs say); > 0 scales the logits by
      1/temperature before the draw.
    top_k: keep only the k highest-probability tokens (0 = off).
    top_p: nucleus sampling — keep the smallest descending-probability
      prefix whose mass reaches top_p (1.0 = off).
    seed: the request's reproducibility anchor. None lets the engine
      assign one from its deterministic counter.
    """

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = None

    def __post_init__(self):
        if not self.temperature >= 0:
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy), got "
                f"{self.temperature!r}")
        if int(self.top_k) < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got "
                             f"{self.top_k!r}")
        if not 0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got "
                             f"{self.top_p!r}")
        if self.seed is not None and int(self.seed) != self.seed:
            raise ValueError(f"seed must be an integer, got "
                             f"{self.seed!r}")

    @property
    def greedy(self):
        """True when this request decodes greedily (argmax) — the
        bit-exact path; the other knobs are inert."""
        return self.temperature <= 0

    def with_seed(self, seed):
        return dataclasses.replace(self, seed=int(seed))


def key_row(seed):
    """Host-side `[2]` base key row for a request seed, as uint32 values
    in an int64 tensor: jax's `fold_in(PRNGKey(seed & 0xFFFFFFFF), seed
    >> 32)` over the seed's 64-bit two's complement (the low word seeds
    the key, the high word folds in), so negative and hash-derived seeds
    never collide. Bit for bit the JAX engine's key row."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    base = (torch.tensor(0, dtype=torch.int64),
            torch.tensor(s & M32, dtype=torch.int64))
    return torch.stack(fold_in(base, s >> 32))


def oracle_probs(logits, params):
    """CPU (numpy) oracle of the masked sampling distribution one
    logits row induces under `params` — independent of the jnp path in
    `ops/sampling.py`, so the statistical acceptance tests compare two
    implementations, not one with itself. Returns float64 `[V]` probs
    (greedy params: a one-hot at the argmax)."""
    lg = np.asarray(logits, np.float64).reshape(-1)
    V = lg.shape[0]
    if params.greedy:
        p = np.zeros(V)
        p[int(np.argmax(lg))] = 1.0
        return p
    lg = lg / float(params.temperature)
    if params.top_k and params.top_k < V:
        kth = np.sort(lg)[::-1][int(params.top_k) - 1]
        lg = np.where(lg >= kth, lg, -np.inf)
    order = np.argsort(-lg, kind="stable")
    e = np.exp(lg[order] - np.max(lg))
    p_desc = e / e.sum()
    keep_desc = (np.cumsum(p_desc) - p_desc) < float(params.top_p)
    keep_desc[0] = True
    keep = np.empty(V, bool)
    keep[order] = keep_desc
    lg = np.where(keep, lg, -np.inf)
    e = np.exp(lg - np.max(lg))
    return e / e.sum()
