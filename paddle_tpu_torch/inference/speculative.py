"""Drafters for speculative decoding on the generation engine: counterpart
of paddle_tpu/inference/speculative.py.

A drafter proposes up to K continuation tokens per lane; the engine scores
all K+1 positions in one verify pass (`GPTModel.forward_verify_paged`) and
accepts the longest draft prefix equal to the target's own argmax. The
engine decodes greedily, so acceptance is exact: the emitted stream equals
the non-speculative one whatever the drafter proposes.

The drafter contract:

    drafter.propose(prompt, generated, k) -> sequence of <= k ints

`prompt` is the request's int32 prompt array, `generated` the tokens
emitted so far (host values); fewer than k tokens, or none, is always
legal.

`NgramDrafter` (prompt lookup) and `draft_window` are copied from the JAX
package line for line, so both packages propose the same tokens for the
same context. `GptDrafter` greedy-decodes a small port GPT, which runs its
forward under `torch.no_grad()` on the draft model's own device.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

__all__ = ["NgramDrafter", "GptDrafter", "draft_window",
           "draft_thread_state"]


def draft_window(drafter, prompt, generated, budget, vocab):
    """One lane's proposal for its next verify window, junk-filtered: the
    longest prefix of in-vocab tokens of `drafter.propose(prompt,
    generated, budget)`, capped at `budget`. The serial scheduler and the
    async core's drafter thread share this one definition.

    Thread-safety contract (JAX's): both drafters are pure functions of
    (prompt, generated, budget) — `NgramDrafter` is numpy over a private
    copy of the context, `GptDrafter` runs eager torch forwards with no
    mutable state — so this may run off the step thread as long as the
    caller passes a SNAPSHOT of `generated` (the step thread appends to
    the live list) and enters `draft_thread_state` there."""
    draft = []
    if budget > 0:
        for t in drafter.propose(prompt, generated, budget):
            t = int(t)
            if not 0 <= t < vocab or len(draft) >= budget:
                break                  # junk proposal: verify nothing
            draft.append(t)
    return draft


def draft_thread_state(drafter):
    """Capture, on the calling (step) thread, the torch state a drafter's
    proposals run under, and return a context manager that enters it on
    another thread. Grad mode and the current CUDA device and stream are
    per thread in torch: a helper thread starts with grad on, device 0 and
    the default stream. The context turns grad off and, for a drafter
    with a model on a card, makes that card current with the caller's
    current stream on it, so the helper's proposals are the step
    thread's token for token."""
    model = getattr(drafter, "model", None)
    dev = getattr(model, "device", None)
    dev = None if dev is None else torch.device(dev)
    stream = torch.cuda.current_stream(dev) \
        if dev is not None and dev.type == "cuda" else None

    @contextmanager
    def enter():
        with torch.no_grad():
            if stream is None:
                yield
                return
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                yield
    return enter


class NgramDrafter:
    """Model-free prompt-lookup drafter.

    Tries the longest n-gram first (`max_ngram` down to `min_ngram`): take
    the lane's last n tokens, find the most recent EARLIER occurrence of
    that n-gram in the lane's context, and propose the tokens that
    followed it. No proposal when nothing matches."""

    def __init__(self, max_ngram=3, min_ngram=1):
        if min_ngram < 1:
            raise ValueError("min_ngram must be >= 1")
        if max_ngram < min_ngram:
            raise ValueError("max_ngram must be >= min_ngram")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, prompt, generated, k):
        if k <= 0:
            return []
        ctx = np.asarray(prompt, np.int64).reshape(-1)
        if len(generated):
            ctx = np.concatenate(
                [ctx, np.asarray(list(generated), np.int64)])
        L = len(ctx)
        # n is capped so a match can still offer >= 1 continuation
        for n in range(min(self.max_ngram, L - 1),
                       self.min_ngram - 1, -1):
            pat = ctx[L - n:]
            win = np.lib.stride_tricks.sliding_window_view(ctx, n)
            starts = np.nonzero((win == pat).all(axis=1))[0]
            # drop matches with no room for a continuation token —
            # including the query suffix itself (start == L - n)
            starts = starts[starts <= L - n - 1]
            if starts.size:
                s0 = int(starts[-1])           # most recent occurrence
                return [int(t) for t in ctx[s0 + n:s0 + n + k]]
        return []


class GptDrafter:
    """Learned drafter: greedy decode of a small port GPT
    (`GPTForCausalLM`) sharing the target's tokenizer.

        draft = GPTForCausalLM(GPTConfig.tiny(...)).eval()
        engine = GenerationEngine(model, spec_decode_k=4,
                                  drafter=GptDrafter(draft))

    A context holding ids outside the draft vocab proposes nothing.
    Proposals are the draft model's argmax continuations of
    `prompt + generated`, fed again one token at a time with the context
    clipped from the left to the draft model's position table."""

    def __init__(self, model, max_context=None):
        cfg = model.config
        if model.training and cfg.dropout > 0:
            raise ValueError(
                "GptDrafter decodes deterministically (no dropout) — "
                "call draft_model.eval() first")
        self.model = model
        self.max_context = cfg.max_seq_len if max_context is None \
            else int(max_context)
        if self.max_context < 1 \
                or self.max_context > cfg.max_seq_len:
            raise ValueError(
                f"max_context={self.max_context} must be in "
                f"[1, {cfg.max_seq_len}] (the draft position table)")

    @torch.no_grad()
    def _next_token(self, window):
        ids = torch.as_tensor(np.asarray(window, np.int64)[None],
                              device=self.model.device)
        logits = self.model(ids)               # [1, S, V]
        return int(logits[0, -1].argmax())

    def propose(self, prompt, generated, k):
        if k <= 0:
            return []
        ctx = [int(t) for t in np.asarray(prompt, np.int64).reshape(-1)]
        ctx += [int(t) for t in generated]
        vocab = self.model.config.vocab_size
        if any(t < 0 or t >= vocab for t in ctx):
            return []                  # disjoint id space: don't guess
        out = []
        for _ in range(int(k)):
            t = self._next_token(ctx[-self.max_context:])
            out.append(t)
            ctx.append(t)
        return out
