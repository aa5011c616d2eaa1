"""The optimizer update as one pass: the wrapper of
`csrc/optimizer_update.cu` and its plain version.

Counterpart of the JAX package's optimizer step, which runs the whole
update as one jitted, donated XLA program (paddle_tpu/optimizer/
optimizer.py `update_all`), XLA fusing each parameter's `_single_update`
into one pass over its bytes. The plain version is the optimizer's own
per-parameter loop of `_single_update` (PyTorch ops, each writing an fp32
temporary); the kernel applies the same arithmetic, with the same
roundings, to every parameter of one (device, dtype) group in one launch,
reading p, g and the fp32 accumulators once and writing p and the
accumulators once.

`optimizer_update(opt, group, lr, step)` takes the plain version for CPU
tensors and launches the kernel for CUDA tensors, or raises; it never
falls back. It counts kernel launches in `.launches` and plain updates of
a group, on any device, in `.plain_calls`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import cpp_extension

__all__ = ["optimizer_update", "optimizer_update_plain", "KINDS"]

#: the kernel's update rules, by the name an optimizer's `_kernel_spec` gives
KINDS = {"adamw": 0, "adam": 1, "momentum": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HYPER = ("b1", "omb1", "b2", "omb2", "inv_c1", "inv_c2", "eps", "lr", "mom",
          "wd")


@functools.lru_cache(maxsize=None)
def _kernel():
    """(the C entry point, elements a block updates)."""
    lib = cpp_extension.load("optimizer_update")
    fn = lib.optimizer_update
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, I, ctypes.c_longlong, I, I] + [F] * len(_HYPER) + [I, P]
    fn.restype = I
    chunk = lib.optimizer_update_chunk
    chunk.argtypes = []
    chunk.restype = I
    return fn, chunk()


def optimizer_update_plain(opt, group, lr, step):
    """The plain version: `opt._single_update` on each (index, parameter,
    grad) of `group`, in order."""
    optimizer_update.plain_calls += 1
    for i, p, g in group:
        acc = {k: v[i] for k, v in opt._accumulators.items()}
        opt._single_update(i, p, g, acc, lr, step)


def _layout(t):
    """The (size, stride) of each dimension of `t` longer than one: two
    tensors of one shape with the same layout hold each element at the
    same offset."""
    return tuple((n, st) for n, st in zip(t.shape, t.stride()) if n != 1)


def _dense(t):
    """Whether the elements of `t` fill one span of `t.numel()` slots from
    `t.data_ptr()` (dense, non-overlapping, positive strides), as the
    kernel walks them: contiguous, channels_last or any permutation."""
    span = 1
    for n, st in sorted(_layout(t), key=lambda d: d[1]):
        if st != span:
            return False
        span *= n
    return True


def _spans(group, names, accs):
    """Check `group` and return its (parameter, grad) pairs laid out as the
    kernel walks them: every parameter dense, its grad and accumulators in
    its layout. A grad in another layout is copied into the parameter's
    (autograd gives the parameter's own); an accumulator in another layout
    (made before the parameter's layout changed) is replaced, once, by a
    copy in the parameter's."""
    p0 = group[0][1]
    if p0.dtype not in _DTYPE_CODE:
        raise ValueError(f"optimizer_update: parameter dtype {p0.dtype} has "
                         "no kernel (float32 or bfloat16)")
    out = []
    for i, p, g in group:
        if p.device != p0.device or p.dtype != p0.dtype:
            raise ValueError("optimizer_update: a group shares one device "
                             "and one dtype")
        if (g.device != p.device or g.dtype != p.dtype
                or g.shape != p.shape):
            raise ValueError(f"optimizer_update: the grad of parameter {i} "
                             "must match its device, dtype and shape")
        if p.numel() and not _dense(p):
            raise ValueError(f"optimizer_update: parameter {i} must be dense "
                             "(its elements one span of memory, in any "
                             "order of dimensions)")
        if _layout(g) != _layout(p):
            g = torch.empty_like(p).copy_(g)
        for name in names:
            a = accs[name][i]
            if (a.device != p.device or a.dtype != torch.float32
                    or a.shape != p.shape):
                raise ValueError(f"optimizer_update: accumulator {name} of "
                                 f"parameter {i} must be float32 of its "
                                 "shape on its device")
            if _layout(a) != _layout(p):
                accs[name][i] = torch.empty_like(
                    p, dtype=torch.float32).copy_(a)
        out.append((i, p, g))
    return out


def optimizer_update(opt, group, lr, step):
    """Apply `opt`'s update at learning rate `lr` and 0-based step `step` to
    `group`, a list of (index, parameter, grad) that share one device and
    dtype, in place. CPU tensors take `optimizer_update_plain`; CUDA tensors
    launch the kernel once for the whole group (float32 or bfloat16
    parameters and grads of one dtype, each parameter dense in any layout;
    fp32 accumulators; see `_spans`), the
    rule and its scalars from `opt._kernel_spec(lr, step)`, or raise."""
    if not group:
        return
    if group[0][1].device.type == "cpu":
        optimizer_update_plain(opt, group, lr, step)
        return
    spec = opt._kernel_spec(lr, step)
    names = spec["accumulators"]
    accs = opt._accumulators
    group = _spans(group, names, accs)
    fn, chunk = _kernel()
    decay = spec.get("decay")
    rows, blocks = [], 0
    for i, p, g in group:
        n = p.numel()
        if n == 0:
            continue
        bits = int(np.float32(decay[i] if decay else 0.0).view(np.int32))
        rows.append([p.data_ptr(), g.data_ptr(), accs[names[0]][i].data_ptr(),
                     accs[names[1]][i].data_ptr() if len(names) > 1 else 0,
                     n, blocks, bits, 0])
        blocks += -(-n // chunk)
    if not rows:
        return
    p0 = group[0][1]
    # one host-to-device copy a step (the grads are new tensors every
    # step), from pinned memory so that the host does not wait for the
    # card's queue
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        p0.device, non_blocking=True)
    hyper = spec["hyper"]
    stream = torch.cuda.current_stream(p0.device).cuda_stream
    optimizer_update.launches += 1
    err = fn(table.data_ptr(), len(rows), blocks, KINDS[spec["kind"]],
             _DTYPE_CODE[p0.dtype], *(float(hyper.get(k, 0.0)) for k in _HYPER),
             int(hyper.get("nesterov", 0)), stream)
    if err:
        raise RuntimeError(f"optimizer_update kernel launch failed: CUDA "
                           f"error {err}")


optimizer_update.launches = 0
optimizer_update.plain_calls = 0
