"""Fused conv+BN+ReLU for eval: the kernels' wrappers, their plain PyTorch
version and the backend seam. Counterpart of the eval half of
paddle_tpu/ops/pallas/conv.py.

`csrc/conv_bn_relu.cu` replaces `_conv1x1_kernel` (through
`_conv1x1_call`) and `_conv3x3_kernel` (through `_conv3x3_call`):
`conv1x1_bn_relu` and `conv3x3_bn_relu` launch them, and
`fused_conv_bn_relu` picks one by the filter's size. Both compute

    y = cast(relu?(conv(x, w) * scale + shift))

with fp32 sums of input-dtype products, the folded BatchNorm affine
(`scale`, `shift`, fp32 `[Cout]`) and an optional ReLU in fp32, and one
cast back to x's dtype: `conv_bn_relu_reference`'s numeric contract, which
`conv_bn_relu_plain` repeats. It is not the dense composition's: that
rounds the conv to x's dtype before the BatchNorm, so at bf16 the two
routes differ by about one bf16 rounding.

Layout at the op: x NHWC `[N, H, W, Cin]`, w HWIO `[kh, kw, Cin, Cout]`,
the output NHWC, as in JAX. The model keeps its activations in
`torch.channels_last` memory, so its NCHW tensors are NHWC views for free
(`nn/fused.py`). The kernels read x in place: a stride-2 1x1 samples
`x[:, ::2, ::2]` and a 3x3 reads taps outside the input as zero, so
neither slices nor pads a copy.

Each kernel wrapper takes the plain version for a CPU tensor and launches
its kernel for a CUDA tensor, or raises; it never falls back. It counts
its launches in `.launches` and every call of its plain version, on any
device, in `.plain_calls`. `fused_conv_bn_relu.dense_calls` counts the
composition route of `ConvBNReLU` (the port of `CONV_PATH_STATS`'s eval
"dense" count).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from ..utils import cpp_extension

__all__ = ["CONV_BACKENDS", "normalize_conv_padding",
           "conv_shapes_supported", "resolve_conv_backend",
           "conv_bn_relu_plain", "conv1x1_bn_relu", "conv3x3_bn_relu",
           "fused_conv_bn_relu"]

CONV_BACKENDS = ("auto", "dense", "pallas")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _pair(v=1):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * 2


def normalize_conv_padding(padding=0, kernel=3, stride=1, in_hw=None):
    """Paddle/lax padding spec -> ((top, bottom), (left, right)).

    Accepts an int, a 2-int per-dim pad, 2 (lo, hi) pairs, a 4-int
    (top, bottom, left, right), or "SAME"/"VALID". "SAME" needs `in_hw`
    because lax pads it asymmetrically at stride > 1 (total =
    (ceil(d/s)-1)*s + k - d, lo = total//2)."""
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride)
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return ((0, 0), (0, 0))
        if p == "SAME":
            if in_hw is None:
                raise ValueError("SAME padding needs the input H/W")
            out = []
            for d, k, s in zip(in_hw, (kh, kw), (sh, sw)):
                total = max((-(-d // s) - 1) * s + k - d, 0)
                out.append((total // 2, total - total // 2))
            return tuple(out)
        raise ValueError(f"unsupported conv padding {padding!r}")
    if isinstance(padding, (list, tuple)):
        if len(padding) == 2 and all(
                isinstance(p, (list, tuple)) for p in padding):
            return tuple((int(lo), int(hi)) for lo, hi in padding)
        if len(padding) == 2:
            return tuple((int(p), int(p)) for p in padding)
        if len(padding) == 4:
            return ((int(padding[0]), int(padding[1])),
                    (int(padding[2]), int(padding[3])))
        raise ValueError(f"unsupported conv padding {padding!r}")
    p = int(padding)
    return ((p, p), (p, p))


def conv_shapes_supported(kernel=3, stride=1, in_channels=8,
                          out_channels=8, dilation=1, groups=1,
                          padding=0):
    """Static-shape gate for the fused kernels: k in {1, 3} square, stride
    in {1, 2} square, no dilation or groups, channel counts in multiples
    of 8, and zero padding for the 1x1 family (a padded 1x1 conv is not a
    matmul). Everything else, the 7x7/s2 stem above all, runs the dense
    composition."""
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    if (kh, kw) not in ((1, 1), (3, 3)) or kh != kw:
        return False
    if sh != sw or sh not in (1, 2):
        return False
    if dh != 1 or dw != 1 or groups != 1:
        return False
    if in_channels % 8 or out_channels % 8:
        return False
    if (kh, kw) == (1, 1) and not isinstance(padding, str):
        pads = normalize_conv_padding(padding, kernel, stride,
                                      in_hw=(8, 8))
        if any(p != (0, 0) for p in pads):
            return False
    return True


def resolve_conv_backend(backend=None, *, kernel=(3, 3), stride=(1, 1),
                         in_channels=8, out_channels=8, dilation=1,
                         groups=1, padding=0):
    """Resolve `auto`/`dense`/`pallas` to the backend a fused conv block
    runs, once, at construction. `pallas` names the hand-written kernels
    (the JAX package's name, kept for API parity). Shapes
    `conv_shapes_supported` rejects resolve `dense` whatever was asked; a
    supported shape honours an explicit `dense` or `pallas`, and `auto`
    takes the kernels, as JAX's `auto` does on its accelerator. On the CPU
    the kernel route runs the plain version."""
    requested = backend or "auto"
    if requested not in CONV_BACKENDS:
        raise ValueError(f"conv backend must be one of {CONV_BACKENDS}, "
                         f"got {requested!r}")
    if not conv_shapes_supported(kernel, stride, in_channels, out_channels,
                                 dilation, groups, padding):
        return "dense"
    return "dense" if requested == "dense" else "pallas"


def _geometry(x, w, stride, padding):
    """(k, stride, ((top, bottom), (left, right)), Ho, Wo) of an NHWC x and
    HWIO w, checked against `conv_shapes_supported`."""
    N, H, W, Cin = x.shape
    kh, kw, wcin, Cout = w.shape
    s, sw = _pair(stride)
    pads = normalize_conv_padding(padding, (kh, kw), (s, sw), in_hw=(H, W))
    if wcin != Cin or not conv_shapes_supported(
            (kh, kw), (s, sw), Cin, Cout, padding=pads):
        raise ValueError(
            f"fused conv kernels do not cover k={kh}x{kw} s={s}x{sw} "
            f"cin={Cin} (w: {wcin}) cout={Cout} pad={pads}: resolve the "
            "backend first and run the dense composition")
    (pt, pb), (pl, pr) = pads
    Ho = (H + pt + pb - kh) // s + 1
    Wo = (W + pl + pr - kw) // s + 1
    if Ho < 1 or Wo < 1:
        raise ValueError(f"fused conv: empty output for H={H} W={W} "
                         f"pad={pads} stride={s}")
    return kh, s, pads, Ho, Wo


def conv_bn_relu_plain(x, w, scale, shift, stride=1, padding=0, relu=True):
    """Plain PyTorch version of both kernels, `conv_bn_relu_reference`'s
    arithmetic: x NHWC, w HWIO, scale/shift `[Cout]`; the conv over the
    zero-padded input in fp32 (the inputs cast to fp32 first, so every
    product is exact and the sums are fp32), `* scale + shift` in fp32,
    optional ReLU, one cast to x's dtype. Returns NHWC. On the card its
    fp32 conv is cuDNN's, which takes TF32 unless
    `torch.backends.cudnn.allow_tf32` is False. Any geometry; counted in
    the plain calls of the kernel of w's size."""
    (conv1x1_bn_relu if w.shape[0] == 1
     else conv3x3_bn_relu).plain_calls += 1
    (pt, pb), (pl, pr) = normalize_conv_padding(padding, w.shape[:2], stride,
                                                in_hw=x.shape[1:3])
    xf = F.pad(x.permute(0, 3, 1, 2).float(), (pl, pr, pt, pb))
    out = F.conv2d(xf, w.permute(3, 2, 0, 1).float(), stride=_pair(stride))
    out = out * scale.float().view(1, -1, 1, 1) \
        + shift.float().view(1, -1, 1, 1)
    if relu:
        out = torch.relu(out)
    return out.to(x.dtype).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _bind(name):
    """C function `name` of the conv kernel library: x, w, scale, shift and
    out pointers; dtype, N, H, W, Cin, Cout, Ho, Wo, stride, pad top, pad
    left and relu as ints; the stream."""
    fn = getattr(cpp_extension.load("conv_bn_relu"), name)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 5 + [I] * 12 + [P]
    fn.restype = I
    return fn


def _launch(wrapper, k, x, w, scale, shift, stride, padding, relu):
    """Shared body of the two kernel wrappers: the plain version for a CPU
    x, else the checks and one launch of kernel `k` (1 or 3)."""
    kh, s, pads, Ho, Wo = _geometry(x, w, stride, padding)
    if kh != k:
        raise ValueError(f"{wrapper.__name__} takes a {k}x{k} filter, got "
                         f"{tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv_bn_relu_plain(x, w, scale, shift, stride, padding, relu)
    N, H, W, Cin = x.shape
    Cout = w.shape[3]
    for name, t in (("x", x), ("w", w), ("scale", scale),
                    ("shift", shift)):
        if t.device != x.device:
            raise ValueError(f"{wrapper.__name__}: {name} is on {t.device}, "
                             f"x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{wrapper.__name__}: {name} must be contiguous"
                             " (x NHWC: a channels_last NCHW tensor permuted "
                             "to (0, 2, 3, 1) is)")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"{wrapper.__name__}: x and w must share float32 or "
                         f"bfloat16, got {x.dtype} and {w.dtype}")
    if (scale.dtype != torch.float32 or shift.dtype != torch.float32
            or scale.shape != (Cout,) or shift.shape != (Cout,)):
        raise ValueError(f"{wrapper.__name__}: scale and shift must be "
                         f"float32 [{Cout}]")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{wrapper.__name__}: x and w must be 16-byte "
                         "aligned")
    out = torch.empty((N, Ho, Wo, Cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _bind(f"conv{k}x{k}_bn_relu")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    wrapper.launches += 1
    err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
             out.data_ptr(), _DTYPE_CODE[x.dtype], N, H, W, Cin, Cout, Ho, Wo,
             s, pads[0][0], pads[1][0], int(bool(relu)), stream)
    if err:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {err}")
    return out


def conv1x1_bn_relu(x, w, scale, shift, stride=1, padding=0, relu=True):
    """Fused 1x1 conv+BN+ReLU (B7, `_conv1x1_kernel`): x NHWC, w
    `[1, 1, Cin, Cout]`, stride 1 or 2, zero padding. CPU tensors take the
    plain version; CUDA tensors launch the kernel (float32 or bfloat16,
    contiguous, 16-byte aligned, channels multiples of 8, fp32 scale and
    shift) or raise."""
    return _launch(conv1x1_bn_relu, 1, x, w, scale, shift, stride, padding,
                   relu)


def conv3x3_bn_relu(x, w, scale, shift, stride=1, padding=0, relu=True):
    """Fused 3x3 conv+BN+ReLU (B8, `_conv3x3_kernel`): x NHWC, w
    `[3, 3, Cin, Cout]`, stride 1 or 2, any padding (symmetric, SAME's
    asymmetric halo, VALID). CPU tensors take the plain version; CUDA
    tensors launch the kernel (as `conv1x1_bn_relu`) or raise."""
    return _launch(conv3x3_bn_relu, 3, x, w, scale, shift, stride, padding,
                   relu)


conv1x1_bn_relu.launches = 0
conv1x1_bn_relu.plain_calls = 0
conv3x3_bn_relu.launches = 0
conv3x3_bn_relu.plain_calls = 0


def fused_conv_bn_relu(x, w, scale, shift, stride=1, padding=0, relu=True):
    """Fused conv+BN+ReLU, NHWC: x `[N, H, W, Cin]`, w `[kh, kw, Cin, Cout]`
    (HWIO), scale/shift `[Cout]`, the BatchNorm affine folded to
    `y = conv(x) * scale + shift` (scale = gamma * rsqrt(var + eps),
    shift = beta - mean * scale). `padding` takes ints, pairs, (lo, hi)
    pairs and "SAME"/"VALID". Forward only, the eval op. Routes to
    `conv1x1_bn_relu` or `conv3x3_bn_relu` by the filter's size; raises on
    shapes `conv_shapes_supported` rejects (resolve the backend first, as
    `ConvBNReLU` does)."""
    scale = scale.to(torch.float32)
    shift = shift.to(torch.float32)
    if w.shape[0] == 1:
        return conv1x1_bn_relu(x, w, scale, shift, stride, padding, relu)
    return conv3x3_bn_relu(x, w, scale, shift, stride, padding, relu)


fused_conv_bn_relu.dense_calls = 0
