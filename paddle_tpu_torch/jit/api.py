"""`TrainStep`: counterpart of paddle_tpu/jit/api.py `TrainStep`.

The JAX package compiles forward, loss, backward, clip and optimizer
update into one XLA program with donated buffers. PyTorch runs eagerly, so
here one step is those same stages run in order on the model's device:
the model's forward, `loss_fn(out, label)` (or the model's output as the
loss), `loss.backward()` (through the attention kernels' autograd
functions), then the optimizer's update, which clips and updates the
parameters in place. `run_scan` and `run_repeat` are plain loops over that
step.

As in the JAX package, the step updates the traced set: the model's
trainable parameters that the optimizer holds. A parameter of that set
that the loss does not reach gets a zero grad, as `jax.value_and_grad`
gives it (paddle_tpu/jit/api.py:710-714), so decay and momentum still move
it.

Gradient merge (`accumulate_steps=K`, `make_accum_fns` and
`_call_accumulate` there) sums each micro-step's grads into fp32 buffers
(`ops.grad_merge.grad_merge`) and updates from their mean on the K-th call
(`grad_finish`). A `GradScaler` (`scaler=`, `build_step_fn`'s scaler branch
there) runs the backward on the scaled loss, tests the scaled grads for
values that are not finite, unscales them by a divide (`grad_unscale`, or
in `grad_finish` under merge) and skips the whole update on overflow,
leaving the parameters, the optimizer's accumulators, the model's buffers
and the step count as they were; the host reads the flag once a step (or
window), as the JAX package's `bool(found_inf)` does.

Telemetry (`telemetry=`, an `observability.TrainingTelemetry`) records one
observation an optimizer step, as the JAX package's `__call__` does: the
time from the step's first call (a merge window's first micro-batch) to its
loss on the host, one wait on the loss, and the loss. A failed call disarms
the timer, and a window that failed part-way records nothing. It only
observes: the update is bitwise the same with it off.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.grad_merge import grad_finish, grad_merge, grad_table, \
    grad_unscale
from ..ops.optimizer_update import _layout

__all__ = ["TrainStep"]


def _detached(out):
    """`out` with every tensor in it detached (tuples, lists and dicts
    walked), as the JAX step's outputs carry no graph."""
    if torch.is_tensor(out):
        return out.detach()
    if isinstance(out, (tuple, list)):
        return type(out)(_detached(o) for o in out)
    if isinstance(out, dict):
        return {k: _detached(v) for k, v in out.items()}
    return out


class TrainStep:
    """One training step over (model, optimizer, loss_fn).

        step = TrainStep(model, opt, loss_fn)   # loss_fn(model_out, label)
        loss = step(x, label)                   # or step(x, label=label)

    A trailing positional input is the label whenever there are two or
    more and `label` is not given, also when `loss_fn` is None: then the
    model's output is the loss and the label is dropped, never passed to
    the model (pass `label=` to keep every positional for the model).
    Returns the loss, detached (unscaled under a scaler), or with
    `with_outputs` `(loss, outputs)`.

    `accumulate_steps=K` merges K calls' grads into one update from their
    mean; `scaler` (an `amp.GradScaler`) scales the loss and skips the
    update on overflow. `with_outputs` with K > 1 raises, as in the JAX
    package. `telemetry` (an `observability.TrainingTelemetry`) observes
    each optimizer step (module docstring)."""

    def __init__(self, model, optimizer, loss_fn=None, with_outputs=False,
                 accumulate_steps=1, scaler=None, telemetry=None):
        self.telemetry = telemetry
        self._tel_t0 = None
        self._tel_taint = False
        self.accumulate_steps = int(accumulate_steps)
        if with_outputs and self.accumulate_steps > 1:
            raise NotImplementedError(
                "accumulate_steps with with_outputs is not supported")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.with_outputs = with_outputs
        self.scaler = scaler
        # the traced set: trainable parameters the optimizer also holds, in
        # the model's order (model.parameters() is deduplicated)
        opt_index = {id(p): j for j, p in
                     enumerate(optimizer._parameter_list)}
        self._params = [p for p in model.parameters()
                        if p.requires_grad and id(p) in opt_index]
        self._acc_idx = [opt_index[id(p)] for p in self._params]
        self._buffers = list(model.buffers())
        self._accum_count = 0
        self._grad_bufs = None
        self._window_flags = None

    def _with_scaler(self):
        return self.scaler is not None and self.scaler.is_enable()

    def _check_plain(self, what):
        """The multi-step loops apply a full update per step: neither loss
        scaling nor gradient merge."""
        if self._with_scaler():
            raise NotImplementedError(
                f"{what} does not support a GradScaler; call the step per "
                "batch instead")
        if self.accumulate_steps > 1:
            raise NotImplementedError(
                f"{what} does not support accumulate_steps>1; call the step "
                "per micro-batch instead")

    def _scale(self):
        """The scaler's scale as an fp32 value."""
        return float(np.float32(self.scaler.get_scale()))

    def _forward_backward(self, inputs, label, scale):
        """(loss, outputs) of one forward, after the backward of the loss
        (times `scale` in fp32 when given)."""
        self.model.zero_grad(set_to_none=True)
        out = self.model(*inputs)
        loss = out if self.loss_fn is None else self.loss_fn(out, label)
        (loss if scale is None else loss.float() * scale).backward()
        return loss.detach(), out

    def _grads(self):
        """The traced set's grads in its parameters' layouts, a zero grad
        where the loss did not reach a parameter."""
        out = []
        for p in self._params:
            g = p.grad
            if g is None:
                g = torch.zeros_like(p)
            elif _layout(g) != _layout(p):
                g = torch.empty_like(p).copy_(g)
            out.append(g)
        return out

    def _groups(self, grads):
        """The traced set's (index, parameter, grad) in lists of one
        device and dtype, as the optimizer groups them."""
        return self.optimizer._groups(list(zip(self._params, grads)))

    def _apply(self, grads):
        """The optimizer's update (clip included) over the traced set."""
        opt = self.optimizer
        pg = [(p, None) for p in opt._parameter_list]
        for j, g in zip(self._acc_idx, grads):
            pg[j] = (opt._parameter_list[j], g)
        opt._update(pg)

    def _snapshot(self):
        """A copy of the model's buffers, taken before a scaled step's
        forward (None without a scaler or buffers)."""
        if not (self._with_scaler() and self._buffers):
            return None
        return [b.detach().clone() for b in self._buffers]

    def _keep_buffers(self, saved, flags):
        """Each of the model's buffers set back to its snapshot where a
        flag is raised, picked on the device (no host read), as the JAX
        package's `jnp.where(found_inf, b, nb)`."""
        if saved is None or not flags:
            return
        raised = {}
        for b, s in zip(self._buffers, saved):
            f = raised.get(b.device)
            if f is None:
                f = raised[b.device] = torch.stack(
                    [x.to(b.device) for x in flags.values()]).any()
            b.copy_(torch.where(f, s, b))

    @staticmethod
    def _flag(device):
        return torch.zeros(1, dtype=torch.int32, device=device)

    def _finish_scaler(self, skipped):
        self.scaler._found_inf = skipped
        self.scaler.update()

    def __call__(self, *inputs, label=None):
        if self.telemetry is None:
            return self._call_inner(*inputs, label=label)
        # gradient merge: the K micro-batch calls of one optimizer step
        # record ONE observation, timed from the window's first call to the
        # K-th call's loss, with one wait
        if self._tel_t0 is None:
            self._tel_t0 = time.perf_counter()
        try:
            out = self._call_inner(*inputs, label=label)
        except BaseException:
            # a failed micro-batch must not leave the timer armed; if
            # earlier micro-batches of this window ran, the window ends
            # with a partial timer: taint it so no skewed sample lands
            self._tel_t0 = None
            if self.accumulate_steps > 1 and self._accum_count != 0:
                self._tel_taint = True
            raise
        if self.accumulate_steps > 1 and self._accum_count != 0:
            return out                     # mid-window micro-batch
        if self._tel_taint:
            self._tel_taint = False        # tainted window: no sample
            self._tel_t0 = None
            return out
        loss = (out[0] if isinstance(out, tuple) else out).cpu()  # the wait
        dt = time.perf_counter() - self._tel_t0
        self._tel_t0 = None
        self.telemetry.observe_step(
            dt, loss=float(loss) if loss.numel() == 1 else None)
        return out

    def _call_inner(self, *inputs, label=None):
        if label is None and len(inputs) >= 2:
            *inputs, label = inputs
        if self.accumulate_steps > 1:
            loss = self._call_accumulate(inputs, label)
            self.optimizer.clear_grad()
            return loss
        with_scaler = self._with_scaler()
        scale = self._scale() if with_scaler else None
        saved = self._snapshot()
        loss, out = self._forward_backward(inputs, label, scale)
        grads = self._grads()
        skipped = False
        with torch.no_grad():
            if with_scaler:
                flags = {}
                for group in self._groups(grads):
                    dev = group[0][2].device
                    grad_unscale([g for _, _, g in group], scale,
                                 flags.setdefault(dev, self._flag(dev)))
                self._keep_buffers(saved, flags)
                skipped = any(bool(f.item()) for f in flags.values())
            if not skipped:
                self._apply(grads)
            if with_scaler:
                self._finish_scaler(skipped)
        self.optimizer.clear_grad()
        if self.with_outputs:
            return loss, _detached(out)
        return loss

    def _call_accumulate(self, inputs, label):
        """One micro-step of gradient merge; the update on the K-th."""
        K = self.accumulate_steps
        with_scaler = self._with_scaler()
        scale = self._scale() if with_scaler else None
        if self._grad_bufs is None:
            self._grad_bufs = [torch.zeros_like(p, dtype=torch.float32)
                               for p in self._params]
        first = self._accum_count == 0
        if with_scaler and first:
            self._window_flags = {}
        # with a scaler, an overflowed micro-step leaves the model's
        # buffers as they were: its own flag picks them on the device
        saved = self._snapshot()
        loss, _ = self._forward_backward(inputs, label, scale)
        grads = self._grads()
        with torch.no_grad():
            groups, micro = [], {}
            for group in self._groups(grads):
                dev = group[0][2].device
                gs = [g for _, _, g in group]
                bs = [self._grad_bufs[i] for i, _, _ in group]
                flags = None
                if with_scaler:
                    flags = [self._window_flags.setdefault(
                        dev, self._flag(dev))]
                    if saved is not None:
                        flags.append(micro.setdefault(dev, self._flag(dev)))
                table = grad_table(gs, bs)
                grad_merge(gs, bs, first, flags, table=table)
                groups.append((gs, bs, table))
            self._keep_buffers(saved, micro)
            self._accum_count += 1
            if self._accum_count < K:
                return loss
            self._accum_count = 0
            skipped = with_scaler and any(
                bool(f.item()) for f in self._window_flags.values())
            if not skipped:
                for gs, bs, table in groups:
                    grad_finish(gs, bs, scale, K, table=table)
                self._apply(grads)
            if with_scaler:
                self._finish_scaler(skipped)
                self._window_flags = None
        return loss

    def run_scan(self, inputs_stacked, labels_stacked):
        """One step per entry of the leading dim of inputs and labels;
        returns the per-step losses `[num_steps]`."""
        assert not self.with_outputs, \
            "run_scan returns losses only; use with_outputs=False"
        self._check_plain("run_scan")
        return torch.stack([self._call_inner(x, y) for x, y in
                            zip(inputs_stacked, labels_stacked)])

    def run_repeat(self, inputs, labels, steps):
        """`steps` steps over the same batch; returns the per-step
        losses."""
        assert not self.with_outputs, \
            "run_repeat returns losses only; use with_outputs=False"
        self._check_plain("run_repeat")
        return torch.stack([self._call_inner(inputs, labels)
                            for _ in range(steps)])
