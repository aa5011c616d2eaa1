"""`TrainStep`: counterpart of paddle_tpu/jit/api.py `TrainStep`.

The JAX package compiles forward, loss, backward, clip and optimizer
update into one XLA program with donated buffers. PyTorch runs eagerly, so
here one step is those same stages run in order on the model's device:
the model's forward, `loss_fn(out, label)`, `loss.backward()` (through the
attention kernels' autograd functions), then `optimizer.step()`, which
clips and updates the parameters in place. `run_scan` and `run_repeat`
are plain loops over that step.
"""
from __future__ import annotations

import torch

__all__ = ["TrainStep"]


class TrainStep:
    """One training step over (model, optimizer, loss_fn).

        step = TrainStep(model, opt, loss_fn)   # loss_fn(model_out, label)
        loss = step(x, label)                   # or step(x, label=label)

    The step updates the parameters that the optimizer holds; the grads
    of every other parameter are cleared before each backward and stay
    unused. Returns the loss, detached. Loss scaling (`scaler`), gradient
    merge (`accumulate_steps > 1`), `with_outputs` and `telemetry` are not
    ported and raise."""

    def __init__(self, model, optimizer, loss_fn, with_outputs=False,
                 accumulate_steps=1, scaler=None, telemetry=None):
        if with_outputs or accumulate_steps != 1 or scaler is not None \
                or telemetry is not None:
            raise NotImplementedError(
                "TrainStep: scaler, accumulate_steps > 1, with_outputs and "
                "telemetry are not ported yet")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn

    def __call__(self, *inputs, label=None):
        # trailing positional label, as the JAX TrainStep takes it
        if label is None and len(inputs) >= 2:
            *inputs, label = inputs
        self.model.zero_grad(set_to_none=True)
        out = self.model(*inputs)
        loss = self.loss_fn(out, label)
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach()

    def run_scan(self, inputs_stacked, labels_stacked):
        """One step per entry of the leading dim of inputs and labels;
        returns the per-step losses `[num_steps]`."""
        return torch.stack([self(x, y) for x, y in
                            zip(inputs_stacked, labels_stacked)])

    def run_repeat(self, inputs, labels, steps):
        """`steps` steps over the same batch; returns the per-step
        losses."""
        return torch.stack([self(inputs, labels) for _ in range(steps)])
