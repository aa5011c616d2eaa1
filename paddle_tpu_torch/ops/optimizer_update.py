"""The optimizer update as one pass: the wrapper of
`csrc/optimizer_update.cu` and its plain version.

Counterpart of the JAX package's optimizer step, which runs the whole
update as one jitted, donated XLA program (paddle_tpu/optimizer/
optimizer.py `update_all`), XLA fusing each parameter's `_single_update`
into one pass over its bytes. The plain version is the optimizer's own
per-parameter loop of `_single_update` (PyTorch ops, each writing an fp32
temporary); the kernel applies the same arithmetic, with the same
roundings, to every parameter of one (device, dtype) group in one launch,
reading p, g and the accumulators once and writing p and the accumulators
once. Lars and Lamb first take two norms a parameter in a norm pass of
their own (`optimizer_norms`, two launches over the same table).

`optimizer_update(opt, group, lr, step)` takes the plain version for CPU
tensors and launches the kernel for CUDA tensors, or raises; it never
falls back. It counts kernel launches in `.launches` and plain updates of
a group, on any device, in `.plain_calls`; `optimizer_norms` counts its
passes likewise.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.tensor import plain
from ..utils import cpp_extension

__all__ = ["optimizer_update", "optimizer_update_plain", "optimizer_norms",
           "optimizer_norms_plain", "KINDS"]

#: the kernel's update rules, by the name an optimizer's `_kernel_spec` gives
KINDS = {"adamw": 0, "adam": 1, "momentum": 2, "sgd": 3, "adagrad": 4,
         "rmsprop": 5, "adadelta": 6, "lars": 7, "lamb": 8}
#: the rules that scale a step by norms over the whole parameter
NORM_KINDS = (KINDS["lars"], KINDS["lamb"])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's scalars, in the order of its `Hyper`
_HYPER = ("b1", "omb1", "b2", "omb2", "inv_c1", "inv_c2", "eps", "lr", "mom",
          "wd", "rho", "omrho", "coeff")


@functools.lru_cache(maxsize=None)
def _kernel():
    """(the update's and the norm pass's C entry points, elements a block
    updates)."""
    lib = cpp_extension.load("optimizer_update")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    count = lib.optimizer_update_hyper
    count.argtypes = []
    count.restype = I
    if count() != len(_HYPER):
        raise RuntimeError("optimizer_update: the kernel's scalars are not "
                           "the wrapper's")
    fn = lib.optimizer_update
    fn.argtypes = [P, I, L, I, I, I, P, I, P, P]
    fn.restype = I
    norms = lib.optimizer_norms
    norms.argtypes = [P, I, L, I, I, P, P, P, P]
    norms.restype = I
    chunk = lib.optimizer_update_chunk
    chunk.argtypes = []
    chunk.restype = I
    return fn, norms, chunk()


def optimizer_update_plain(opt, group, lr, step):
    """The plain version: `opt._single_update` on each (index, parameter,
    grad) of `group`, in order."""
    optimizer_update.plain_calls += 1
    for i, p, g in group:
        acc = {k: v[i] for k, v in opt._accumulators.items()}
        opt._single_update(i, p, g, acc, lr, step)


def optimizer_norms_plain(opt, group, lr, step):
    """The plain version of the norm pass: for each (index, parameter,
    grad) of `group` with elements, in order, the fp32 norms (||p||, ||x||)
    that Lars' or Lamb's step scales by (`opt._norm_operand`: Lars' grad,
    Lamb's r from the current moments, which stay as they are), as a
    [rows, 2] fp32 tensor."""
    optimizer_norms.plain_calls += 1
    out = []
    for i, p, g in group:
        if p.numel() == 0:
            continue
        acc = {k: v[i] for k, v in opt._accumulators.items()}
        x = opt._norm_operand(i, p, g, acc, step)
        out.append(torch.stack([torch.sqrt(torch.sum(torch.square(p.float()))),
                                torch.sqrt(torch.sum(torch.square(x)))]))
    return torch.stack(out)


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


def _spans(group, names, accs, acc_fp32):
    """Check `group` and return its (parameter, grad) pairs laid out as the
    kernel walks them: every parameter dense, its grad and accumulators in
    its layout, the accumulators fp32 (`acc_fp32`) or in the parameter's
    dtype. A grad in another layout is copied into the parameter's
    (autograd gives the parameter's own); an accumulator in another layout
    (made before the parameter's layout changed) is replaced, once, by a
    copy in the parameter's. A paddle `Parameter` and its grad come back as
    plain aliases (paddle's `numel()` is a tensor)."""
    group = [(i, plain(p), plain(g)) for i, p, g in group]
    p0 = group[0][1]
    if p0.dtype not in _DTYPE_CODE:
        raise ValueError(f"optimizer_update: parameter dtype {p0.dtype} has "
                         "no kernel (float32 or bfloat16)")
    acc_dtype = torch.float32 if acc_fp32 else p0.dtype
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
            if (a.device != p.device or a.dtype != acc_dtype
                    or a.shape != p.shape):
                raise ValueError(f"optimizer_update: accumulator {name} of "
                                 f"parameter {i} must be {acc_dtype} of its "
                                 "shape on its device")
            if _layout(a) != _layout(p):
                accs[name][i] = torch.empty_like(p, dtype=acc_dtype).copy_(a)
        out.append((i, p, g))
    return out


def _rows(entries, chunk):
    """The rows of a pointer table (csrc/table_walk.cuh) and its grid, from
    `entries`, per tensor (its element count, the pointers of up to five
    tensors, a 32-bit word): a row of int64 for each with elements (the
    first four pointers, the count, the first block, the word, the fifth
    pointer), `chunk` elements a block."""
    rows, blocks = [], 0
    for n, ptrs, word in entries:
        if n == 0:
            continue
        ptrs = list(ptrs) + [0] * (5 - len(ptrs))
        rows.append(ptrs[:4] + [n, blocks, word, ptrs[4]])
        blocks += -(-n // chunk)
    return rows, blocks


class _Table:
    """One group's pointer table on its device (`_rows`): `rows`, `blocks`
    and the grads' `dtype` code as the kernels take them; `table` None
    when no tensor has elements."""

    def __init__(self, entries, chunk, dtype, device):
        rows, self.blocks = _rows(entries, chunk)
        self.rows, self.device = len(rows), device
        self.dtype = _DTYPE_CODE[dtype]
        self.stream = torch.cuda.current_stream(device).cuda_stream
        # one host-to-device copy a call (the grads are new tensors every
        # step), from pinned memory so that the host does not wait for the
        # card's queue
        self.table = None if not rows else torch.tensor(
            rows, dtype=torch.int64).pin_memory().to(device,
                                                     non_blocking=True)


class _Launch(_Table):
    """One group's launch: its checked spec and its pointer table on the
    card (built once, for the norm pass and the update to share)."""

    def __init__(self, opt, group, lr, step):
        spec = opt._kernel_spec(lr, step)
        names = spec["accumulators"]
        if len(names) > 3 or spec["kind"] not in KINDS:
            raise ValueError(f"optimizer_update: no kernel rule for {spec}")
        accs = opt._accumulators
        multi = spec.get("multi_precision", True)
        if not multi and spec["kind"] not in ("adam", "adamw"):
            raise ValueError("optimizer_update: only Adam and AdamW keep "
                             "accumulators in the parameter's dtype")
        group = _spans(group, names, accs, multi)
        decay = spec.get("decay")
        # per parameter: p, g, the first two accumulators, then the third
        # in the row's fifth pointer
        entries = []
        for i, p, g in group:
            ptr = [accs[k][i].data_ptr() for k in names] + [0, 0, 0]
            bits = int(np.float32(decay[i] if decay else 0.0).view(np.int32))
            entries.append((p.numel(), [p.data_ptr(), g.data_ptr(), ptr[0],
                                        ptr[1], ptr[2]], bits))
        p0 = group[0][1]
        super().__init__(entries, _kernel()[2], p0.dtype, p0.device)
        self.kind = KINDS[spec["kind"]]
        self.bf16_acc = int(not multi and p0.dtype == torch.bfloat16)
        hyper = spec["hyper"]
        self.flag = int(hyper.get("flag", 0))
        self.hyper = (ctypes.c_float * len(_HYPER))(
            *(float(hyper.get(k, 0.0)) for k in _HYPER))


def _norms(launch):
    """Launch the norm pass over `launch`'s table: its [rows, 2] norms."""
    optimizer_norms.launches += 1
    partials = torch.empty((launch.blocks, 2), dtype=torch.float32,
                           device=launch.device)
    norms = torch.empty((launch.rows, 2), dtype=torch.float32,
                        device=launch.device)
    err = _kernel()[1](launch.table.data_ptr(), launch.rows, launch.blocks,
                       launch.kind, launch.dtype, launch.hyper,
                       partials.data_ptr(), norms.data_ptr(), launch.stream)
    if err:
        raise RuntimeError(f"optimizer_norms kernel launch failed: CUDA "
                           f"error {err}")
    return norms


def optimizer_norms(opt, group, lr, step):
    """Lars' or Lamb's norm pass over `group` (see `optimizer_update`):
    the [rows, 2] fp32 norms (||p||, ||g|| or ||r||) of its parameters
    with elements, in order. CPU tensors take `optimizer_norms_plain`;
    CUDA tensors launch the two kernels of the pass (each block's partial
    sums, then one CTA a parameter summing them in a fixed order), or
    raise."""
    if group[0][1].device.type == "cpu":
        return optimizer_norms_plain(opt, group, lr, step)
    launch = _Launch(opt, group, lr, step)
    if launch.kind not in NORM_KINDS:
        raise ValueError("optimizer_norms: only Lars and Lamb take norms")
    if launch.table is None:
        return torch.empty((0, 2), dtype=torch.float32, device=launch.device)
    return _norms(launch)


def optimizer_update(opt, group, lr, step):
    """Apply `opt`'s update at learning rate `lr` and 0-based step `step` to
    `group`, a list of (index, parameter, grad) that share one device and
    dtype, in place. CPU tensors take `optimizer_update_plain`; CUDA tensors
    launch the kernel once for the whole group (float32 or bfloat16
    parameters and grads of one dtype, each parameter dense in any layout;
    fp32 accumulators, or Adam's and AdamW's in the parameter's dtype
    without multi-precision; see `_spans`), Lars and Lamb after their norm
    pass (`optimizer_norms`, over the same table), the rule and its scalars
    from `opt._kernel_spec(lr, step)`, or raise."""
    if not group:
        return
    if group[0][1].device.type == "cpu":
        optimizer_update_plain(opt, group, lr, step)
        return
    launch = _Launch(opt, group, lr, step)
    if launch.table is None:
        return
    norms = _norms(launch) if launch.kind in NORM_KINDS else None
    optimizer_update.launches += 1
    err = _kernel()[0](launch.table.data_ptr(), launch.rows, launch.blocks,
                       launch.kind, launch.dtype, launch.bf16_acc,
                       launch.hyper, launch.flag,
                       None if norms is None else norms.data_ptr(),
                       launch.stream)
    if err:
        raise RuntimeError(f"optimizer_update kernel launch failed: CUDA "
                           f"error {err}")


optimizer_update.launches = 0
optimizer_update.plain_calls = 0
optimizer_norms.launches = 0
optimizer_norms.plain_calls = 0
