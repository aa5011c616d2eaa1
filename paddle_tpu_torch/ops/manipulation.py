"""Shape and layout ops of the paddle surface: counterpart of
paddle_tpu/ops/manipulation.py (python/paddle/tensor/manipulation.py),
over torch ops, through `ops.dispatch` under the JAX package's names.
Index operands may be int32 (the port's "int64"); torch's index ops take
int64, so the ops cast inside the call. Outputs that JAX
materializes (slices, splits) may be torch views here: the values are the
same.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.tensor import Tensor
from .dispatch import (OpStats, apply, apply_nograd, as_tensor, const,
                       unwrap)

builtins_slice = builtins.slice

__all__ = [
    "reshape", "flatten", "squeeze", "unsqueeze", "transpose", "moveaxis",
    "concat", "stack", "split", "chunk", "unbind", "tile", "expand",
    "expand_as", "broadcast_to", "flip", "roll", "gather", "gather_nd",
    "scatter", "index_select", "masked_select", "take_along_axis",
    "put_along_axis", "slice", "strided_slice", "getitem", "clone",
    "repeat_interleave", "unstack", "as_complex", "as_real", "pad",
    "crop", "rot90", "numel", "tensordot", "squeeze_", "unsqueeze_",
    "swapaxes", "swapdims", "vsplit", "hsplit", "dsplit", "take",
    "as_strided", "diff", "scatter_nd", "searchsorted", "bucketize",
]


def _index(index, like):
    """An index operand as a plain int64 tensor on `like`'s device."""
    if isinstance(index, torch.Tensor):
        return unwrap(index).to(device=like.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(index), dtype=torch.int64,
                           device=like.device)


def clone(x):
    return apply("clone", torch.clone, as_tensor(x))


def reshape(x, shape):
    x = as_tensor(x)
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    shape = tuple(int(s) for s in shape)
    return apply("reshape", lambda a: torch.reshape(a, shape), x)


def flatten(x, start_axis=0, stop_axis=-1):
    x = as_tensor(x)
    nd = x.ndim
    sa = start_axis % nd if nd else 0
    so = stop_axis % nd if nd else 0
    return reshape(x, list(x.shape[:sa]) + [-1] + list(x.shape[so + 1:]))


def _norm_axes(axis, ndim):
    if axis is None:
        return None
    if isinstance(axis, (int, np.integer)):
        return (int(axis) % ndim if ndim else 0,)
    return tuple(int(a) % ndim for a in axis)


def squeeze(x, axis=None):
    x = as_tensor(x)
    axes = _norm_axes(axis, x.ndim)
    if axes is None:
        return apply("squeeze", torch.squeeze, x)
    axes = tuple(a for a in axes if x.shape[a] == 1)
    if not axes:
        return clone(x)
    return apply("squeeze", lambda a: torch.squeeze(a, axes), x)


def unsqueeze(x, axis):
    x = as_tensor(x)
    if isinstance(axis, (int, np.integer)):
        axis = [int(axis)]
    # jnp.expand_dims: the axes index the output
    out_nd = x.ndim + len(axis)
    axes = sorted(int(a) % out_nd for a in axis)
    shape, it = [], iter(x.shape)
    for i in range(out_nd):
        shape.append(1 if i in axes else next(it))
    return apply("unsqueeze", lambda a: torch.reshape(a, shape), x)


squeeze_ = squeeze
unsqueeze_ = unsqueeze


def transpose(x, perm=None):
    x = as_tensor(x)
    if perm is None:
        perm = list(range(x.ndim))[::-1]
    perm = [int(p) for p in perm]
    return apply("transpose", lambda a: a.permute(*perm), x)


def moveaxis(x, source, destination):
    return apply("moveaxis",
                 lambda a: torch.movedim(a, source, destination),
                 as_tensor(x))


def concat(xs, axis=0):
    ts = [as_tensor(t) for t in xs]
    axis = int(axis if not isinstance(axis, torch.Tensor) else axis.item())
    return apply("concat", lambda *arrs: torch.cat(arrs, axis), *ts)


def stack(xs, axis=0):
    return apply("stack", lambda *arrs: torch.stack(arrs, axis),
                 *[as_tensor(t) for t in xs])


def split(x, num_or_sections, axis=0):
    x = as_tensor(x)
    axis = int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, (int, np.integer)):
        n = int(num_or_sections)
        if dim % n != 0:
            raise ValueError(
                f"split: axis {axis} size {dim} is not divisible by {n} "
                f"(paddle semantics; pass explicit section sizes instead)")
        sizes = [dim // n] * n
    else:
        sizes = [int(s) for s in num_or_sections]
        neg = [i for i, s in enumerate(sizes) if s < 0]
        if neg:
            sizes[neg[0]] = dim - sum(s for s in sizes if s >= 0)
    if len(sizes) == 1:
        return [clone(x)]
    return list(apply("split", lambda a: tuple(torch.split(a, sizes, axis)),
                      x))


def chunk(x, chunks, axis=0):
    return split(x, chunks, axis)


def unbind(x, axis=0):
    return list(apply("unbind", lambda a: tuple(torch.unbind(a, axis)),
                      as_tensor(x)))


unstack = unbind


def tile(x, repeat_times):
    rt = tuple(int(r) for r in repeat_times)
    return apply("tile", lambda a: torch.tile(a, rt), as_tensor(x))


def expand(x, shape):
    x = as_tensor(x)
    shape = tuple(
        x.shape[i - (len(shape) - x.ndim)] if int(s) == -1 else int(s)
        for i, s in enumerate(shape))
    return apply("expand", lambda a: torch.broadcast_to(a, shape), x)


def expand_as(x, y):
    return expand(x, y.shape)


def broadcast_to(x, shape):
    return expand(x, shape)


def flip(x, axis):
    if isinstance(axis, (int, np.integer)):
        axis = [int(axis)]
    axis = tuple(axis)
    return apply("flip", lambda a: torch.flip(a, axis), as_tensor(x))


def roll(x, shifts, axis=None):
    return apply("roll", lambda a: torch.roll(a, shifts, axis),
                 as_tensor(x))


def gather(x, index, axis=0):
    x = as_tensor(x)
    idx = _index(index, x)

    def fn(a):
        if idx.ndim == 0:
            return a.select(axis, int(idx))
        return torch.index_select(a, axis, idx.reshape(-1))

    return apply("gather", fn, x)


def gather_nd(x, index):
    x = as_tensor(x)
    idx = _index(index, x)
    return apply("gather_nd", lambda a: a[tuple(
        idx[..., i] for i in range(idx.shape[-1]))], x)


def scatter(x, index, updates, overwrite=True):
    x = as_tensor(x)
    updates = as_tensor(updates, x)
    idx = _index(index, x).reshape(-1)
    return apply("scatter", lambda a, u: torch.index_put(
        a, (idx,), u.to(a.dtype), accumulate=not overwrite), x, updates)


def index_select(x, index, axis=0):
    return gather(x, index, axis)


def masked_select(x, mask):
    x = as_tensor(x)
    m = unwrap(as_tensor(mask)).to(x.device)
    return apply_nograd("masked_select",
                        lambda a: torch.masked_select(a, m), x)


def take_along_axis(x, indices, axis):
    x = as_tensor(x)
    idx = _index(indices, x)
    return apply("take_along_axis",
                 lambda a: torch.take_along_dim(a, idx, axis), x)


def put_along_axis(x, indices, values, axis):
    x = as_tensor(x)
    values = as_tensor(values, x)
    idx = _index(indices, x)

    def fn(a, v):
        v = torch.broadcast_to(v.to(a.dtype), idx.shape)
        return torch.scatter(a, axis, idx, v)

    return apply("put_along_axis", fn, x, values)


def slice(x, axes, starts, ends):
    x = as_tensor(x)
    sl = [builtins_slice(None)] * x.ndim
    for ax, st, en in zip(axes, starts, ends):
        sl[ax] = builtins_slice(int(st), int(en))
    sl = tuple(sl)
    return apply("slice", lambda a: a[sl], x)


def strided_slice(x, axes, starts, ends, strides):
    x = as_tensor(x)
    picks = []
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        # Python's slice rules, negative strides too (torch's slicing
        # takes only positive steps)
        rng = range(*builtins_slice(int(st), int(en), int(sd)).indices(
            x.shape[ax]))
        picks.append((ax, torch.as_tensor(list(rng), dtype=torch.int64,
                                          device=x.device)))

    def fn(a):
        for ax, idx in picks:
            a = torch.index_select(a, ax, idx)
        return a

    return apply("strided_slice", fn, x)


def _prep_index(item, like):
    if isinstance(item, torch.Tensor) and not item.dtype == torch.bool:
        return unwrap(item).to(device=like.device, dtype=torch.int64)
    if isinstance(item, torch.Tensor):
        return unwrap(item).to(like.device)
    if isinstance(item, tuple):
        return tuple(_prep_index(i, like) for i in item)
    if isinstance(item, list) and any(isinstance(i, torch.Tensor)
                                      for i in item):
        return [_prep_index(i, like) for i in item]
    return item


def getitem(x, item):
    x = as_tensor(x)
    key = _prep_index(item, x)
    return apply("getitem", lambda a: a[key], x)


def setitem(x, item, value):
    """`x[item] = value` in place. Where autograd records it (x requires
    grad through its graph, or `value` does), the overwrite is a
    differentiable op, JAX's `setitem`: x's old gradient is zeroed at the
    overwritten positions and `value` takes the gradient gathered from
    them (torch's in-place write on a non-leaf, or on a leaf that does not
    require grad). A leaf that requires grad is refused, as in JAX."""
    from ..core.autograd import is_grad_enabled

    key = _prep_index(item, x)
    if isinstance(value, torch.Tensor):
        v = unwrap(value).to(device=x.device, dtype=x.dtype)
    else:
        v = torch.as_tensor(np.asarray(value), device=x.device).to(x.dtype)
    if is_grad_enabled() and x.is_leaf and x.requires_grad:
        raise RuntimeError(
            "in-place __setitem__ on a leaf tensor with stop_gradient=False "
            "is not supported (its .grad would no longer match the stored "
            "value); use paddle.no_grad() or assign to a cloned tensor")
    plain = unwrap(x)
    tgt = plain[key]
    while v.ndim > tgt.ndim and v.shape[0] == 1:
        v = v[0]
    if is_grad_enabled() and (x.requires_grad or v.requires_grad):
        OpStats.record("setitem")
        plain[key] = v
    else:
        with torch.no_grad():
            plain[key] = v
    return x


def repeat_interleave(x, repeats, axis=None):
    x = as_tensor(x)
    if isinstance(repeats, torch.Tensor):
        repeats = unwrap(repeats).to(device=x.device, dtype=torch.int64)
    return apply("repeat_interleave",
                 lambda a: torch.repeat_interleave(a, repeats, axis), x)


def as_complex(x):
    return apply("as_complex", lambda a: torch.complex(a[..., 0], a[..., 1]),
                 as_tensor(x))


def as_real(x):
    return apply("as_real", lambda a: torch.stack(
        [torch.real(a), torch.imag(a)], -1), as_tensor(x))


def _pad_index(n, before, after, mode):
    """numpy.pad's source index of each output position along one axis."""
    i = np.arange(-before, n + after)
    if mode == "edge":
        return np.clip(i, 0, n - 1)
    if mode == "wrap":
        return np.mod(i, n)
    period = 2 * (n - 1)                                  # reflect
    j = np.mod(np.abs(i), period) if period else np.zeros_like(i)
    return np.where(j >= n, period - j, j)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    x = as_tensor(x)
    nd = x.ndim
    if len(pad) == nd * 2:
        cfg = [(int(pad[2 * i]), int(pad[2 * i + 1])) for i in range(nd)]
    else:
        # paddle: pad the last len(pad) // 2 spatial dims of NCHW/NHWC,
        # listed (left, right, top, bottom, ...), the innermost first
        npairs = len(pad) // 2
        pairs = [(int(pad[2 * i]), int(pad[2 * i + 1]))
                 for i in range(npairs)][::-1]
        cfg = [(0, 0)] * (nd - npairs) + pairs
        if data_format.endswith("C") and nd - npairs >= 2:
            cfg = [(0, 0)] + cfg[2:] + [(0, 0)]
    jmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap"}[mode]
    if jmode == "constant":
        flat = [p for pair in cfg[::-1] for p in pair]
        return apply("pad", lambda a: torch.nn.functional.pad(
            a, flat, value=value), x)
    picks = [(ax, torch.as_tensor(_pad_index(x.shape[ax], b, a, jmode),
                                  dtype=torch.int64, device=x.device))
             for ax, (b, a) in enumerate(cfg) if b or a]

    def fn(a):
        for ax, idx in picks:
            a = torch.index_select(a, ax, idx)
        return a

    return apply("pad", fn, x)


def crop(x, shape, offsets=None):
    x = as_tensor(x)
    if offsets is None:
        offsets = [0] * x.ndim
    sl = tuple(builtins_slice(int(o), int(o) + int(s))
               for o, s in zip(offsets, shape))
    return apply("crop", lambda a: a[sl], x)


def rot90(x, k=1, axes=(0, 1)):
    return apply("rot90", lambda a: torch.rot90(a, k, list(axes)),
                 as_tensor(x))


def numel(x):
    x = as_tensor(x)
    return torch.tensor(unwrap(x).numel(), dtype=torch.int32,
                        device=x.device).as_subclass(Tensor)


def tensordot(x, y, axes=2):
    return apply("tensordot", lambda a, b: torch.tensordot(a, b, dims=axes),
                 as_tensor(x), as_tensor(y))


def swapaxes(x, axis1, axis2, name=None):
    return apply("swapaxes", lambda a: torch.swapaxes(a, axis1, axis2),
                 as_tensor(x))


swapdims = swapaxes


def _axis_split(opname, fn, min_ndim):
    """numpy/paddle split-family semantics: an int divides into equal
    sections; a list gives the INDICES to split at."""
    def op(x, num_or_indices, name=None):
        x = as_tensor(x)
        if x.ndim < min_ndim:
            raise ValueError(
                f"{opname} requires at least {min_ndim}-D input, "
                f"got {x.ndim}-D")
        spec = num_or_indices if isinstance(num_or_indices, int) \
            else [int(i) for i in num_or_indices]
        return apply(opname, lambda a: tuple(fn(a, spec)), x)

    op.__name__ = opname
    return op


vsplit = _axis_split("vsplit", torch.vsplit, 2)
hsplit = _axis_split("hsplit", torch.hsplit, 1)
dsplit = _axis_split("dsplit", torch.dsplit, 3)


def take(x, index, mode="raise", name=None):
    """Flattened-index gather (paddle take): index anywhere in
    [-numel, numel). mode: 'raise' validates, 'clip', 'wrap'."""
    if mode not in ("raise", "clip", "wrap"):
        raise ValueError(f"take: invalid mode {mode!r}; "
                         "expected 'raise', 'clip' or 'wrap'")
    x = as_tensor(x)
    idx = _index(index, x)
    n = unwrap(x).numel()
    if mode == "raise" and bool(((idx < -n) | (idx >= n)).any()):
        raise IndexError(f"take: index out of range for numel {n}")
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        idx = torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)
    return apply("take", lambda a: a.reshape(-1)[idx], x)


def as_strided(x, shape, stride, offset=0, name=None):
    """View-by-strides (paddle as_strided) over x's elements in row-major
    order: element [i0, i1, ...] = flat[offset + sum(ik * stride[k])]."""
    x = as_tensor(x)
    shape = tuple(int(s) for s in shape)

    def fn(a):
        flat = a.reshape(-1)
        if not shape:
            return flat[int(offset)]
        idx = torch.full(shape, int(offset), dtype=torch.int64,
                         device=a.device)
        for k, (s, st) in enumerate(zip(shape, stride)):
            view = [1] * len(shape)
            view[k] = s
            idx = idx + torch.arange(s, device=a.device).view(view) * int(st)
        return flat[idx]

    return apply("as_strided", fn, x)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = as_tensor(x)

    def edge(v):
        if v is None:
            return None
        v = const(as_tensor(v, x))
        if v.ndim == 0:
            shape = list(x.shape)
            shape[axis] = 1
            v = v.expand(shape)
        return v

    pre, app = edge(prepend), edge(append)
    return apply("diff", lambda a: torch.diff(a, n, axis, pre, app), x)


def scatter_nd(index, updates, shape, name=None):
    """zeros(shape) scatter-ADDED with updates at index (paddle
    scatter_nd)."""
    updates = as_tensor(updates)
    idx = _index(index, updates)
    shape = tuple(int(s) for s in shape)

    def fn(u):
        z = torch.zeros(shape, dtype=u.dtype, device=u.device)
        return torch.index_put(z, tuple(idx[..., i] for i in range(
            idx.shape[-1])), u, accumulate=True)

    return apply("scatter_nd", fn, updates)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    seq = as_tensor(sorted_sequence)
    vals = unwrap(as_tensor(values, seq)).to(device=seq.device,
                                              dtype=seq.dtype)
    # int32: JAX's int64 is int32 storage (out_int32 changes nothing)
    return apply_nograd("searchsorted", lambda s: torch.searchsorted(
        s, vals, right=right, out_int32=True), seq)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32,
                        right=right)
