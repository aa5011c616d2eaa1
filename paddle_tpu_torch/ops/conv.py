"""Fused conv+BN+ReLU, eval and training: the kernels' wrappers, their
plain PyTorch versions, the training op and the backend seam. Counterpart
of paddle_tpu/ops/pallas/conv.py.

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
composition route of `ConvBNReLU` in eval and `.dense_train_calls` in
training (the port of `CONV_PATH_STATS`'s "dense" and "dense_train"
counts).

Training (the second half of the module) is `fused_conv_bn_relu_train`,
a `torch.autograd.Function` over four more kernels:
`csrc/conv_bn_relu.cu`'s train forwards (`_conv1x1_train_kernel`,
`_conv3x3_train_kernel`: the conv in x's dtype plus fp32 `[2, Cout]` sums
of it and its square, `conv1x1_train` / `conv3x3_train`) and
`csrc/conv_bn_relu_bwd.cu`'s whole 1x1 backward (`_conv1x1_bwd_kernel`,
`conv1x1_bwd`) and 3x3 dWeight (`_conv3x3_dw_kernel`, `conv3x3_dw`); the
3x3 dInput is `conv3x3_bn_relu` (B8) over the dilated dConv, as in JAX.
The BatchNorm normalize, affine and ReLU tail of the forward, and pass 1
of the backward (the mask and the channel sums), are plain torch: XLA
glue in JAX. `conv_bn_relu_train_plain` is the dense composition the op
is held to (`conv_bn_relu_train_reference`).
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch
from torch.nn import functional as F

from ..utils import cpp_extension

__all__ = ["CONV_BACKENDS", "normalize_conv_padding",
           "conv_shapes_supported", "resolve_conv_backend",
           "conv_bn_relu_plain", "conv1x1_bn_relu", "conv3x3_bn_relu",
           "fused_conv_bn_relu", "conv_bn_relu_train_plain",
           "conv_train_plain", "conv_train_partial_rows", "conv1x1_train",
           "conv3x3_train",
           "conv1x1_bwd_plain", "conv1x1_bwd", "conv3x3_dw_plain",
           "conv3x3_dw", "fused_conv_bn_relu_train"]

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
    (the JAX package's name, kept for API parity). The environment's
    `PADDLE_CONV_BACKEND` wins over `backend`, as in JAX (a deploy-time
    switch; empty means unset). Shapes `conv_shapes_supported` rejects
    resolve `dense` whatever was asked; a supported shape honours an
    explicit `dense` or `pallas`, and `auto` takes the kernels, as JAX's
    `auto` does on its accelerator. On the CPU the kernel route runs the
    plain version."""
    requested = os.environ.get("PADDLE_CONV_BACKEND") or backend or "auto"
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


def _conv_f32(x, w, stride, padding):
    """conv(x, w) in fp32, NCHW: x NHWC and w HWIO cast to fp32 first (every
    product exact, fp32 sums), over the zero-padded input. Differentiable."""
    (pt, pb), (pl, pr) = normalize_conv_padding(padding, w.shape[:2], stride,
                                                in_hw=x.shape[1:3])
    xf = F.pad(x.permute(0, 3, 1, 2).float(), (pl, pr, pt, pb))
    return F.conv2d(xf, w.permute(3, 2, 0, 1).float(), stride=_pair(stride))


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
    out = _conv_f32(x, w, stride, padding)
    out = out * scale.float().view(1, -1, 1, 1) \
        + shift.float().view(1, -1, 1, 1)
    if relu:
        out = torch.relu(out)
    return out.to(x.dtype).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _bind(lib, name, n_ptr, n_int):
    """C function `name` of kernel library `lib`: `n_ptr` pointers, `n_int`
    ints, then the stream; returns its cudaError_t."""
    fn = getattr(cpp_extension.load(lib), name)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * n_ptr + [I] * n_int + [P]
    fn.restype = I
    return fn


def _raise_on(err, wrapper):
    if err:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {err}")


def _check_on_card(wrapper, x, named, same_dtype):
    """The checks every kernel wrapper makes before a launch: each tensor on
    x's device and contiguous, x a float32 or bfloat16 tensor, those in
    `same_dtype` of x's dtype, and x and those 16-byte aligned."""
    fn = wrapper.__name__
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous (x NHWC: a "
                             "channels_last NCHW tensor permuted to "
                             "(0, 2, 3, 1) is)")
    if x.dtype not in _DTYPE_CODE or any(
            t.dtype != x.dtype for n, t in named if n in same_dtype):
        raise ValueError(f"{fn}: {', '.join(same_dtype)} must share float32 "
                         f"or bfloat16, got {[t.dtype for _, t in named]}")
    if any(t.data_ptr() % 16 for n, t in named if n in same_dtype):
        raise ValueError(f"{fn}: {', '.join(same_dtype)} must be 16-byte "
                         "aligned")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


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
    _check_on_card(wrapper, x, (("x", x), ("w", w), ("scale", scale),
                                ("shift", shift)), ("x", "w"))
    if (scale.dtype != torch.float32 or shift.dtype != torch.float32
            or scale.shape != (Cout,) or shift.shape != (Cout,)):
        raise ValueError(f"{wrapper.__name__}: scale and shift must be "
                         f"float32 [{Cout}]")
    out = torch.empty((N, Ho, Wo, Cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    # x, w, scale, shift and out; dtype, N, H, W, Cin, Cout, Ho, Wo,
    # stride, pad top, pad left and relu
    fn = _bind("conv_bn_relu", f"conv{k}x{k}_bn_relu", 5, 12)
    wrapper.launches += 1
    _raise_on(fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                 shift.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype], N, H,
                 W, Cin, Cout, Ho, Wo, s, pads[0][0], pads[1][0],
                 int(bool(relu)), _stream(x)), wrapper)
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
fused_conv_bn_relu.dense_train_calls = 0


# ---------------------------------------------------------------------------
# training: the train forwards (B9), the 1x1 backward (B10), the 3x3
# dWeight (B11) and the autograd Function that joins them with B8
# ---------------------------------------------------------------------------
_BM = 128          # output rows per CTA of csrc/conv_bn_relu.cu (kBM)
# B8's tile (csrc/conv_bn_relu.cu kFwdPix, kFwdSlots, kFwdRows)
_FWD_PIX, _FWD_SLOTS, _FWD_ROWS = 128, 640, 64
# a dWeight cuts its pixels into splits until its grid holds about this
# many CTAs: four per SM of the H100's 132
_TARGET_CTAS = 528


def _bn_tail(conv, mean32, var32, gamma, beta, relu, eps):
    """BatchNorm's normalize, affine and ReLU from fp32 batch statistics in
    `batch_norm`'s staging: mean and `inv = rsqrt(var32 + eps)` cast to
    conv's dtype, `(conv - mean) * inv`, `* gamma`, `+ beta`, then ReLU."""
    mean = mean32.to(conv.dtype)
    inv = torch.rsqrt(var32 + eps).to(conv.dtype)
    y = (conv - mean) * inv * gamma + beta
    return torch.relu(y) if relu else y


def conv_bn_relu_train_plain(x, w, gamma, beta, stride=1, padding=0,
                             relu=True, eps=1e-5):
    """The dense training composition (`conv_bn_relu_train_reference`),
    differentiable: x NHWC, w HWIO, gamma and beta `[Cout]`. The conv in
    fp32 from exact products, cast to x's dtype; single-pass fp32 batch
    statistics (mean32, E[x^2] - mean32^2 clamped at 0); `_bn_tail`.
    Returns (y, mean, var), mean and var in x's dtype. Counts no wrapper."""
    conv = _conv_f32(x, w, stride, padding).to(x.dtype).permute(0, 2, 3, 1)
    af = conv.float()
    mean32 = af.mean(dim=(0, 1, 2))
    var32 = torch.clamp_min((af * af).mean(dim=(0, 1, 2)) - mean32 * mean32,
                            0.0)
    y = _bn_tail(conv, mean32, var32, gamma, beta, relu, eps)
    return y, mean32.to(conv.dtype), var32.to(conv.dtype)


def conv_train_plain(x, w, stride=1, padding=0):
    """Plain version of both train-forward kernels: the conv in fp32 from
    exact products, cast once to x's dtype (contiguous NHWC), and fp32
    `[2, Cout]` sums over every pixel of the CAST values and of their
    squares. Counted in the plain calls of the kernel of w's size."""
    (conv1x1_train if w.shape[0] == 1 else conv3x3_train).plain_calls += 1
    conv = _conv_f32(x, w, stride, padding).to(x.dtype) \
        .permute(0, 2, 3, 1).contiguous()
    p = conv.reshape(-1, conv.shape[3]).float()
    return conv, torch.stack([p.sum(0), (p * p).sum(0)])


@functools.lru_cache(maxsize=None)
def conv_train_partial_rows(k, dtype, N, Ho, Wo, stride):
    """Rows of the train forwards' fp32 scratch `[rows, 2, Cout]`: one per
    pixel tile of the kernel that runs (`train_tiles` in
    csrc/conv_bn_relu.cu, whose launch refuses fewer). A tile holds 128
    output pixels in the f32 kernels and in the bf16 1x1 (B7's walk). The
    bf16 3x3 takes B8's tile (`fwd_geom`): TH output rows of TW columns,
    a row wider than the tile in nseg segments, so nseg * ceil(N * Ho /
    TH) tiles, more than ceil(M / 128) where a tile holds fewer than 128
    pixels (112 at 56 x 56)."""
    if dtype != torch.bfloat16 or k == 1:
        return -(-(N * Ho * Wo) // _BM)
    s = stride
    tw = min(Wo, _FWD_PIX, (_FWD_SLOTS // 3 - 3) // s + 1)
    xw = (tw - 1) * s + 3
    nseg = -(-Wo // tw)
    th = 1 if nseg > 1 else _FWD_PIX // tw
    while th > 1:
        # the most image boundaries th output rows from a multiple of th
        # cross widen the patch by 3 - s rows each
        cross = max((r * th + th - 1) // Ho - r * th // Ho for r in range(Ho))
        pr = (th - 1) * s + 3 + cross * (3 - s)
        if pr <= _FWD_ROWS and pr * xw <= _FWD_SLOTS:
            break
        th -= 1
    return nseg * -(-(N * Ho) // th)


def _train_launch(wrapper, k, x, w, stride, padding):
    """Shared body of the train-forward wrappers: the plain version for a
    CPU x, else the checks and one launch of `conv_train` (the kernel, then
    the fixed-order sum of its per-tile statistics, sized by
    `conv_train_partial_rows`)."""
    kh, s, pads, Ho, Wo = _geometry(x, w, stride, padding)
    if kh != k:
        raise ValueError(f"{wrapper.__name__} takes a {k}x{k} filter, got "
                         f"{tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv_train_plain(x, w, stride, padding)
    N, H, W, Cin = x.shape
    Cout = w.shape[3]
    _check_on_card(wrapper, x, (("x", x), ("w", w)), ("x", "w"))
    M = N * Ho * Wo
    out = torch.empty((N, Ho, Wo, Cout), dtype=x.dtype, device=x.device)
    sums = torch.zeros((2, Cout), dtype=torch.float32, device=x.device)
    if M == 0:
        return out, sums
    rows = conv_train_partial_rows(k, x.dtype, N, Ho, Wo, s)
    partial = torch.empty((rows, 2, Cout), dtype=torch.float32,
                          device=x.device)
    # x, w, out, partial and sums; partial's rows, K, dtype, N, H, W, Cin,
    # Cout, Ho, Wo, stride, pad top and pad left
    fn = _bind("conv_bn_relu", "conv_train", 5, 13)
    wrapper.launches += 1
    _raise_on(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 partial.data_ptr(), sums.data_ptr(), rows, k,
                 _DTYPE_CODE[x.dtype], N, H, W, Cin, Cout, Ho, Wo, s,
                 pads[0][0], pads[1][0], _stream(x)), wrapper)
    return out, sums


def conv1x1_train(x, w, stride=1):
    """1x1 conv with the statistics epilogue (B9a, `_conv1x1_train_kernel`):
    x NHWC, w `[1, 1, Cin, Cout]`, stride 1 or 2 (x[:, ::2, ::2] read in
    place). Returns (conv NHWC in x's dtype, fp32 `[2, Cout]` sums of conv
    and conv^2). CPU tensors take the plain version; CUDA tensors launch
    the kernel (bfloat16 on the tensor cores, B7's walk; float32 in fp32
    FMA) or raise."""
    return _train_launch(conv1x1_train, 1, x, w, stride, 0)


def conv3x3_train(x, w, stride=1, padding=1):
    """3x3 conv with the statistics epilogue (B9b, `_conv3x3_train_kernel`):
    as `conv1x1_train` (bfloat16 on B8's walk), any padding
    `conv3x3_bn_relu` takes."""
    return _train_launch(conv3x3_train, 3, x, w, stride, padding)


conv1x1_train.launches = 0
conv1x1_train.plain_calls = 0
conv3x3_train.launches = 0
conv3x3_train.plain_calls = 0


def _splits(M, rows, cols):
    """How a dWeight cuts its M pixels: (splits, chunk). A split's grid has
    ceil(rows / 128) * ceil(cols / 64) tiles; the splits bring the grid to
    about `_TARGET_CTAS` CTAs, with at least 512 pixels each, and chunk is
    a multiple of 8 pixels. Depends on the shape alone, so the order of
    the sums does too."""
    tiles = -(-rows // _BM) * -(-cols // 64)
    splits = max(1, min(-(-_TARGET_CTAS // tiles), -(-M // 512)))
    chunk = -(-(-(-M // splits)) // 8) * 8
    return -(-M // chunk), chunk


def conv1x1_bwd_plain(x, dy, y, rows, wt, stride=1, relu=True):
    """Plain version of the 1x1 backward kernel, `_conv1x1_bwd_kernel`'s
    arithmetic: x NHWC (sampled at `[:, ::s, ::s]`), dy and the saved conv
    y `[N, Ho, Wo, Cout]`, rows the fp32 bundle `[8, Cout]` = [mean_n,
    inv_n, gamma, beta, mean32, rstd32, c1, c2], wt `[Cout, Cin]`. The ReLU
    mask from `pre = ((y - mean_n) * inv_n) * gamma + beta` in fp32 (the
    dtype-cast statistics, not the forward's staging), `dconv = (gamma *
    rstd32) * (dz - c1 - xhat * c2)` cast to x's dtype, then `dx = dconv @
    wt` (fp32 sums, one cast) at the sampled pixels (zero elsewhere) and
    `dw = x^T @ dconv` in fp32 `[Cin, Cout]`."""
    conv1x1_bwd.plain_calls += 1
    xs = x[:, ::stride, ::stride] if stride != 1 else x
    N, Ho, Wo, Cin = xs.shape
    Cout = wt.shape[0]
    r = rows.float()
    yv = y.reshape(-1, Cout).float()
    dz = dy.reshape(-1, Cout).float()
    if relu:
        pre = (yv - r[0]) * r[1] * r[2] + r[3]
        dz = torch.where(pre > 0, dz, 0.0)
    xh = (yv - r[4]) * r[5]
    dcv = ((r[2] * r[5]) * (dz - r[6] - xh * r[7])).to(x.dtype).float()
    dxs = (dcv @ wt.float()).to(x.dtype).view(N, Ho, Wo, Cin)
    dw = xs.reshape(-1, Cin).float().t() @ dcv
    if stride == 1:
        return dxs, dw
    dx = x.new_zeros(x.shape)
    dx[:, ::stride, ::stride] = dxs
    return dx, dw


def conv1x1_bwd(x, dy, y, rows, wt, stride=1, relu=True):
    """The whole 1x1 backward (B10, `_conv1x1_bwd_kernel`): arguments and
    results as `conv1x1_bwd_plain`, dx in x's dtype, dw fp32. CPU tensors
    take the plain version; CUDA tensors launch the kernels (dX, the dW
    partials of the pixel splits, their fixed-order sum: float32 or
    bfloat16 x, dy, y and wt, fp32 rows, contiguous, channels multiples of
    8) or raise."""
    if x.device.type == "cpu":
        return conv1x1_bwd_plain(x, dy, y, rows, wt, stride, relu)
    N, H, W, Cin = x.shape
    Cout = wt.shape[0]
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    if (stride not in (1, 2) or Cin % 8 or Cout % 8
            or tuple(wt.shape) != (Cout, Cin)
            or tuple(dy.shape) != (N, Ho, Wo, Cout)
            or tuple(y.shape) != (N, Ho, Wo, Cout)
            or tuple(rows.shape) != (8, Cout)
            or rows.dtype != torch.float32):
        raise ValueError(
            f"conv1x1_bwd: x {tuple(x.shape)} stride {stride} takes dy and y "
            f"[{N}, {Ho}, {Wo}, Cout], wt [Cout, {Cin}], fp32 rows [8, Cout],"
            f" channels multiples of 8; got dy {tuple(dy.shape)}, y "
            f"{tuple(y.shape)}, wt {tuple(wt.shape)}, rows "
            f"{tuple(rows.shape)} {rows.dtype}")
    _check_on_card(conv1x1_bwd, x, (("x", x), ("dy", dy), ("y", y),
                                    ("rows", rows), ("wt", wt)),
                   ("x", "dy", "y", "wt"))
    M = N * Ho * Wo
    dx = (torch.zeros if stride != 1 else torch.empty)(
        (N, H, W, Cin), dtype=x.dtype, device=x.device)
    if M == 0:
        return dx.zero_(), torch.zeros((Cin, Cout), dtype=torch.float32,
                                       device=x.device)
    dw = torch.empty((Cin, Cout), dtype=torch.float32, device=x.device)
    splits, chunk = _splits(M, Cin, Cout)
    partial = torch.empty((splits, Cin, Cout), dtype=torch.float32,
                          device=x.device)
    # x, dy, y, rows, wt, dx, dw and partial; dtype, N, H, W, Cin, Cout,
    # Ho, Wo, stride, relu, splits and chunk
    fn = _bind("conv_bn_relu_bwd", "conv1x1_bwd", 8, 12)
    conv1x1_bwd.launches += 1
    _raise_on(fn(x.data_ptr(), dy.data_ptr(), y.data_ptr(), rows.data_ptr(),
                 wt.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                 partial.data_ptr(), _DTYPE_CODE[x.dtype], N, H, W, Cin,
                 Cout, Ho, Wo, stride, int(bool(relu)), splits, chunk,
                 _stream(x)), conv1x1_bwd)
    return dx, dw


conv1x1_bwd.launches = 0
conv1x1_bwd.plain_calls = 0


def conv3x3_dw_plain(x, g, stride=1, padding=1):
    """Plain version of the 3x3 dWeight kernel, `_conv3x3_dw_kernel`'s
    arithmetic: x NHWC over its zero padding, the dConv g `[N, Ho, Wo,
    Cout]`; for each of the nine taps the shifted, strided input slice
    `[M, Cin]` transposed times g `[M, Cout]` in fp32. Returns fp32
    `[3, 3, Cin, Cout]`."""
    conv3x3_dw.plain_calls += 1
    (pt, pb), (pl, pr) = normalize_conv_padding(padding, 3, stride,
                                                in_hw=x.shape[1:3])
    N, Ho, Wo, Cout = g.shape
    Cin = x.shape[3]
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    gf = g.reshape(-1, Cout).float()
    dw = torch.empty((3, 3, Cin, Cout), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            xs = xp[:, dy:dy + stride * (Ho - 1) + 1:stride,
                    dx:dx + stride * (Wo - 1) + 1:stride]
            dw[dy, dx] = xs.reshape(-1, Cin).t() @ gf
    return dw


def conv3x3_dw(x, g, stride=1, padding=1):
    """3x3 dWeight (B11, `_conv3x3_dw_kernel`): x NHWC, g the dConv `[N, Ho,
    Wo, Cout]` in x's dtype, stride 1 or 2, any padding `conv3x3_bn_relu`
    takes. Returns fp32 `[3, 3, Cin, Cout]`. CPU tensors take the plain
    version; CUDA tensors launch the kernels (the partials of the pixel
    splits, their fixed-order sum) or raise."""
    w_like = torch.empty((3, 3, x.shape[3], g.shape[3]), device="meta")
    _, s, pads, Ho, Wo = _geometry(x, w_like, stride, padding)
    N, H, W, Cin = x.shape
    Cout = g.shape[3]
    if tuple(g.shape) != (N, Ho, Wo, Cout):
        raise ValueError(f"conv3x3_dw: g must be [{N}, {Ho}, {Wo}, Cout] "
                         f"for x {tuple(x.shape)}, got {tuple(g.shape)}")
    if x.device.type == "cpu":
        return conv3x3_dw_plain(x, g, stride, padding)
    _check_on_card(conv3x3_dw, x, (("x", x), ("g", g)), ("x", "g"))
    M = N * Ho * Wo
    if M == 0:
        return torch.zeros((3, 3, Cin, Cout), dtype=torch.float32,
                           device=x.device)
    dw = torch.empty((3, 3, Cin, Cout), dtype=torch.float32, device=x.device)
    splits, chunk = _splits(M, 9 * Cin, Cout)
    partial = torch.empty((splits, 9 * Cin, Cout), dtype=torch.float32,
                          device=x.device)
    # x, g, dw and partial; dtype, N, H, W, Cin, Cout, Ho, Wo, stride,
    # pad top, pad left, splits and chunk
    fn = _bind("conv_bn_relu_bwd", "conv3x3_dw", 4, 13)
    conv3x3_dw.launches += 1
    _raise_on(fn(x.data_ptr(), g.data_ptr(), dw.data_ptr(),
                 partial.data_ptr(), _DTYPE_CODE[x.dtype], N, H, W, Cin,
                 Cout, Ho, Wo, s, pads[0][0], pads[1][0], splits, chunk,
                 _stream(x)), conv3x3_dw)
    return dw


conv3x3_dw.launches = 0
conv3x3_dw.plain_calls = 0


def _train_forward(x, w, gamma, beta, stride, pads, relu, eps):
    """`_train_fwd_impl`: the conv and its channel sums from one train
    kernel, fp32 batch statistics from the sums, then `_bn_tail`. Returns
    (y, conv, mean32, var32)."""
    if w.shape[0] == 1:
        conv, sums = conv1x1_train(x, w, stride)
    else:
        conv, sums = conv3x3_train(x, w, stride, pads)
    m = float(conv.numel() // conv.shape[3])
    mean32 = sums[0] / m
    var32 = torch.clamp_min(sums[1] / m - mean32 * mean32, 0.0)
    return (_bn_tail(conv, mean32, var32, gamma, beta, relu, eps), conv,
            mean32, var32)


def _train_backward(x, w, gamma, beta, conv, mean32, var32, dy, stride,
                    pads, relu, eps):
    """`_train_bwd_impl`, in two passes. Pass 1, plain torch: the ReLU mask
    recomputed with the forward's staging, the fp32 channel sums dbeta32 =
    sum(dz) and dgamma32 = sum(dz * xhat), and from them c1 and c2. Pass 2,
    the kernels: a 1x1 runs B10 on the fp32 bundle; a 3x3 materialises
    dConv once in x's dtype (dilated by the stride), runs B8 over it
    against the flipped, In/Out-swapped filter at padding 2 (scale 1,
    shift 0, no ReLU) and crops dx from it, and runs B11 for dw. Returns
    (dx, dw, dgamma, dbeta) in the dtypes of x, w, gamma and beta."""
    dt = x.dtype
    N, H, W, Cin = x.shape
    _, Ho, Wo, Cout = conv.shape
    m = float(N * Ho * Wo)
    rstd32 = torch.rsqrt(var32 + eps)
    g32, b32 = gamma.float(), beta.float()
    mean_dt, inv_dt = mean32.to(dt), rstd32.to(dt)
    dz = dy.float()
    if relu:
        pre = ((conv - mean_dt) * inv_dt).float() * g32 + b32
        dz = torch.where(pre > 0, dz, 0.0)
    xh = (conv.float() - mean32) * rstd32
    dbeta32 = dz.sum(dim=(0, 1, 2))
    dgamma32 = (dz * xh).sum(dim=(0, 1, 2))
    c1, c2 = dbeta32 / m, dgamma32 / m
    if w.shape[0] == 1:
        rows = torch.stack([mean_dt.float(), inv_dt.float(), g32, b32,
                            mean32, rstd32, c1, c2])
        dx, dw = conv1x1_bwd(x, dy, conv, rows, w[0, 0].t().contiguous(),
                             stride, relu)
        dw = dw.view(1, 1, Cin, Cout)
    else:
        dconv = ((g32 * rstd32) * (dz - c1 - xh * c2)).to(dt)
        if stride != 1:
            dil = dconv.new_zeros((N, stride * (Ho - 1) + 1,
                                   stride * (Wo - 1) + 1, Cout))
            dil[:, ::stride, ::stride] = dconv
        else:
            dil = dconv
        wflip = w.flip(0, 1).transpose(2, 3).contiguous()
        dxp = conv3x3_bn_relu(
            dil, wflip, torch.ones(Cin, device=x.device),
            torch.zeros(Cin, device=x.device), 1, 2, relu=False)
        (pt, _), (pl, _) = pads
        # padded rows and columns the forward never read get no gradient;
        # the pads are 0 where the walk already covers them
        dxp = F.pad(dxp, (0, 0, 0, max(0, pl + W - dxp.shape[2]),
                          0, max(0, pt + H - dxp.shape[1])))
        dx = dxp[:, pt:pt + H, pl:pl + W]
        dw = conv3x3_dw(x, dconv, stride, pads)
    return (dx, dw.to(w.dtype), dgamma32.to(gamma.dtype),
            dbeta32.to(beta.dtype))


class _ConvBNReLUTrain(torch.autograd.Function):
    """The training op's autograd join (JAX's `_train_vjp` custom_vjp): the
    forward runs `_train_forward` and saves x, w, gamma, beta, the conv
    and the fp32 statistics; the backward runs `_train_backward` from dy
    alone. mean and var feed only the running-stat update, outside
    autograd, so they carry no gradient."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, stride, pads, relu, eps):
        y, conv, mean32, var32 = _train_forward(x, w, gamma, beta, stride,
                                                pads, relu, eps)
        ctx.save_for_backward(x, w, gamma, beta, conv, mean32, var32)
        ctx.cfg = (stride, pads, relu, eps)
        mean, var = mean32.to(conv.dtype), var32.to(conv.dtype)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        grads = _train_backward(*ctx.saved_tensors, dy.contiguous(),
                                *ctx.cfg)
        return (*grads, None, None, None, None)


def fused_conv_bn_relu_train(x, w, gamma, beta, stride=1, padding=0,
                             relu=True, eps=1e-5):
    """Fused conv+BatchNorm(+ReLU) for training, NHWC: x `[N, H, W, Cin]`,
    w HWIO, gamma and beta the BatchNorm affine `[Cout]`, batch statistics.
    Returns (y, mean, var): y differentiable in x, w, gamma and beta
    through the kernels' backward; mean and var (x's dtype) for the
    caller's running-stat update, as `batch_norm` updates it. `padding` as
    `fused_conv_bn_relu`. Raises on shapes `conv_shapes_supported`
    rejects. There is no per-call geometry gate (JAX's
    `conv_train_geometry_tileable` is a TPU tiling limit): every supported
    shape takes the kernels. Counted in `.calls` (JAX's
    `CONV_PATH_STATS["pallas_train"]`)."""
    _, s, pads, _, _ = _geometry(x, w, stride, padding)
    fused_conv_bn_relu_train.calls += 1
    return _ConvBNReLUTrain.apply(x, w, gamma, beta, s, pads, bool(relu),
                                  float(eps))


fused_conv_bn_relu_train.calls = 0
