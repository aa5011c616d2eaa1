"""Gradient merge and loss-scale unscaling: the wrappers of
`csrc/grad_merge.cu` and their plain versions.

Counterparts of the elementwise work that the JAX package's compiled
steps fuse into their XLA programs (paddle_tpu/jit/api.py):
- `grad_merge` (K1): gradient merge's `b + g.astype(f32)` into fp32 merge
  buffers, one micro-step (`make_accum_fns` `acc_fn`, :616 and :637), and
  with a scaler the OR of the micro-step's non-finite test over the
  scaled grads into a device flag (:609-611);
- `grad_finish` (K2): the end of a merge window, `(b / scale / K)` or
  `(b / K)` rounded to the parameter's dtype (`upd_fn`, :625 and :642).
  Jitted XLA turns the divide by the constant K into a multiply by its
  fp32 reciprocal; the divide by the traced scale stays a divide. Both
  versions here do the same, in that order;
- `grad_unscale` (K2): the scaler step without merge (`build_step_fn`,
  :527-530): the non-finite test over the scaled grads into the flag,
  then `(g.float() / scale)` rounded back into `g` in place. A divide,
  never a multiply by `1 / scale`, whose reciprocal is subnormal at large
  scales.

Each takes one group of grads (one device, one dtype: float32 or
bfloat16), each dense and laid out as its fp32 buffer. For CPU tensors it
runs the plain version; for CUDA tensors it launches the kernel once for
the whole group, or raises. It counts launches in `.launches` and plain
calls in `.plain_calls`. A flag is an int32 tensor of one element that a
kernel sets to 1 where it sees a value that is not finite; the host zeroes
it and reads it. `grad_table` builds a group's pointer table once, for the
merge and the finish of one call to share.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cpp_extension
from .optimizer_update import _DTYPE_CODE, _dense, _layout, _Table

__all__ = ["grad_merge", "grad_finish", "grad_unscale", "grad_table",
           "grad_merge_plain", "grad_finish_plain", "grad_unscale_plain"]


@functools.lru_cache(maxsize=None)
def _kernels():
    """(merge, finish, unscale C entry points, elements a block takes)."""
    lib = cpp_extension.load("grad_merge")
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    merge, finish, unscale = lib.grad_merge, lib.grad_finish, \
        lib.grad_unscale
    merge.argtypes = [P, I, L, I, I, P, P, P]
    finish.argtypes = [P, I, L, I, I, F, F, P]
    unscale.argtypes = [P, I, L, I, F, P, P]
    for fn in (merge, finish, unscale):
        fn.restype = I
    chunk = lib.grad_merge_chunk
    chunk.argtypes = []
    chunk.restype = I
    return merge, finish, unscale, chunk()


def _not_finite(g):
    return (~torch.isfinite(g).all()).to(torch.int32)


def _raise_flags(flags, g):
    for f in flags or ():
        f.bitwise_or_(_not_finite(g))


def _scale_tensor(scale, like):
    """The scale as an fp32 tensor on `like`'s device: a tensor divided by
    it divides on either device (a CUDA tensor divided by a Python scalar
    would multiply by the reciprocal)."""
    return torch.tensor(scale, dtype=torch.float32, device=like.device)


def _inv_k(k):
    """fp32(1 / K), as XLA folds the divide by the constant K."""
    return float(torch.tensor(1.0, dtype=torch.float32)
                 / torch.tensor(float(k), dtype=torch.float32))


def grad_merge_plain(grads, bufs, first, flags=None):
    """`b = 0 + g.float()` at a window's first micro-step, else
    `b += g.float()`; each flag raised if a grad is not finite."""
    grad_merge.plain_calls += 1
    for g, b in zip(grads, bufs):
        _raise_flags(flags, g)
        if first:
            b.zero_()
        b.add_(g)


def grad_finish_plain(grads, bufs, scale, k):
    """`g = (b / scale * fp32(1/K))`, or `b * fp32(1/K)` when `scale` is
    None, rounded to g's dtype."""
    grad_finish.plain_calls += 1
    inv_k = _inv_k(k)
    for g, b in zip(grads, bufs):
        x = b if scale is None else b / _scale_tensor(scale, b)
        g.copy_(x * inv_k)


def grad_unscale_plain(grads, scale, flag):
    """The flag raised if a grad is not finite, then `g = g.float() /
    scale` rounded back into g."""
    grad_unscale.plain_calls += 1
    for g in grads:
        _raise_flags((flag,), g)
        g.copy_(g.float() / _scale_tensor(scale, g))


def _check(grads, bufs):
    """Refuse what the kernels do not take: a group of one device and one
    dtype (float32 or bfloat16), each grad dense, each buffer fp32 of its
    grad's shape and layout on its device."""
    g0 = grads[0]
    if g0.dtype not in _DTYPE_CODE:
        raise ValueError(f"grad_merge: grad dtype {g0.dtype} has no kernel "
                         "(float32 or bfloat16)")
    for i, g in enumerate(grads):
        if g.device != g0.device or g.dtype != g0.dtype:
            raise ValueError("grad_merge: a group shares one device and one "
                             "dtype")
        if g.numel() and not _dense(g):
            raise ValueError(f"grad_merge: grad {i} must be dense (its "
                             "elements one span of memory)")
        if bufs is not None:
            b = bufs[i]
            if (b.device != g.device or b.dtype != torch.float32
                    or b.shape != g.shape or _layout(b) != _layout(g)):
                raise ValueError(f"grad_merge: buffer {i} must be float32 "
                                 "of its grad's shape and layout on its "
                                 "device")


def grad_table(grads, bufs=None):
    """The pointer table of one group of CUDA grads (and their fp32
    buffers), checked; None for CPU tensors, which take the plain
    versions."""
    if not grads or grads[0].device.type == "cpu":
        return None
    _check(grads, bufs)
    table = _Table([(g.numel(), [g.data_ptr(),
                                 bufs[i].data_ptr() if bufs else 0], 0)
                    for i, g in enumerate(grads)], _kernels()[3],
                   grads[0].dtype, grads[0].device)
    return table if table.table is not None else None


def _ptr(flag):
    return None if flag is None else flag.data_ptr()


def _launched(err, what):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def grad_merge(grads, bufs, first, flags=None, table=None):
    """One micro-step of gradient merge over a group: `b = 0 + g.float()`
    when `first` (the window's first micro-step: bit for bit the add to a
    zeroed buffer, without the zeroing pass), else `b += g.float()`; up to
    two flags raised if a grad is not finite."""
    if not grads:
        return
    if grads[0].device.type == "cpu":
        grad_merge_plain(grads, bufs, first, flags)
        return
    table = table or grad_table(grads, bufs)
    if table is None:
        return
    flags = list(flags or ()) + [None, None]
    grad_merge.launches += 1
    _launched(_kernels()[0](table.table.data_ptr(), table.rows, table.blocks,
                            table.dtype, int(bool(first)), _ptr(flags[0]),
                            _ptr(flags[1]), table.stream), "grad_merge")


def grad_finish(grads, bufs, scale, k, table=None):
    """The end of a merge window over a group: each grad set to its
    buffer divided by `scale` (skipped when None), then times fp32(1/K),
    rounded to the grad's dtype."""
    if not grads:
        return
    if grads[0].device.type == "cpu":
        grad_finish_plain(grads, bufs, scale, k)
        return
    table = table or grad_table(grads, bufs)
    if table is None:
        return
    grad_finish.launches += 1
    _launched(_kernels()[1](table.table.data_ptr(), table.rows, table.blocks,
                            table.dtype, int(scale is not None),
                            1.0 if scale is None else float(scale),
                            _inv_k(k), table.stream), "grad_finish")


def grad_unscale(grads, scale, flag, table=None):
    """The scaler step's unscale over a group, in place: `flag` raised if a
    grad is not finite, then each grad divided by `scale` in fp32 and
    rounded back."""
    if not grads:
        return
    if grads[0].device.type == "cpu":
        grad_unscale_plain(grads, scale, flag)
        return
    table = table or grad_table(grads)
    if table is None:
        return
    grad_unscale.launches += 1
    _launched(_kernels()[2](table.table.data_ptr(), table.rows, table.blocks,
                            table.dtype, float(scale), _ptr(flag),
                            table.stream), "grad_unscale")


for _w in (grad_merge, grad_finish, grad_unscale):
    _w.launches = 0
    _w.plain_calls = 0
del _w
