"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where there is no CUDA device (a CUDA kernel has no
interpret mode). On a machine with a card, without jax installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

This file imports nothing of jax or paddle_tpu. chip_smoke.py holds the
kernels at the serving and training shapes; these cover the other head
dims, lengths, block sizes and window widths the kernels take.

The flash forward B6 (`sdpa_forward`): against `sdpa_forward_plain` at each
dtype and head dim (64 to 256), causal and not, Sq == Skv and Sq != Skv,
ragged lengths; its refusals; `flash_attention`'s library route (B6 with
no gradient, a raise naming the backward with one); a Transformer on the
card against the same Transformer on the CPU.

Conv kernels (B7, B8): against `conv_bn_relu_plain` on the card with
TF32 off, max |kernel - plain| relative to max |plain| (CONV_TOL); the
ResNet on the card against the same ResNet on the CPU. The conv training
kernels (B9a/B9b train forwards, B10 1x1 backward, B11 3x3 dWeight)
against their plain versions over dtype x stride x shape, the training
op's gradients through the kernels against autograd through the plain
composition, and a ResNet-50 train step on the card against the CPU.

Paged kernels: pools must be bit-identical to the plain version's outside
the null block 0, and outputs within tolerance on the live rows of live
slots. Block 0 is a race, not a reference: idle lanes and dead window rows
of every slot write it from concurrent CTAs. For the int8 kernels the
quantization runs once, in plain torch, before both the kernel and its
plain version take the same int8 rows and scale plane.
"""
import math

import pytest
import torch

from paddle_tpu_torch.ops.flash_attention import (
    causal_attention_bwd, causal_attention_bwd_plain, causal_attention_fwd,
    causal_attention_plain, shortseq_attention, shortseq_attention_bwd,
    shortseq_attention_bwd_plain, shortseq_attention_fwd,
    shortseq_attention_plain, flash_attention, pallas_sdpa_forward,
    sdpa_forward, sdpa_forward_plain)
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.conv import (
    conv1x1_bn_relu, conv1x1_bwd, conv1x1_bwd_plain, conv1x1_train,
    conv3x3_bn_relu, conv3x3_dw, conv3x3_dw_plain, conv3x3_train,
    conv_bn_relu_plain, conv_bn_relu_train_plain, conv_train_plain,
    fused_conv_bn_relu, fused_conv_bn_relu_train)
from paddle_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                               paged_decode_attention_int8,
                                               paged_decode_int8_plain,
                                               paged_decode_plain)
from paddle_tpu_torch.ops.paged_verify import (paged_verify_attention,
                                               paged_verify_attention_int8,
                                               paged_verify_int8_plain,
                                               paged_verify_plain)

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# backward: f32 absolute (fp32 sums over up to S terms in another order);
# bf16 relative to the largest |reference| (a P or dS value on a bf16
# rounding boundary may round the other way), plus a floor for S = 1,
# where dq and dk are zero up to rounding
BWD_TOL = {torch.bfloat16: (1e-2, 1e-5), torch.float32: (0.0, 1e-5)}


# shortseq backward, per sequence (per [S, D] slab of bh): max |got - ref|
# <= rel * max |ref| + abs over that slab. An all-padding sequence has p = 1
# on every key, so its gradients sum S unit-size terms (|ref| up to ~115 at
# S 512 against ~5 elsewhere) and fp32 sums in another order differ by a
# small multiple of 1e-7 of that; other sequences keep the causal
# backward's limits.
SHORTSEQ_BWD_TOL = {torch.bfloat16: (1e-2, 1e-5), torch.float32: (4e-6, 1e-5)}

# B6 against its plain version, max |kernel - plain|: bf16 relative to max
# |plain| (both divide the same fp32 sums up to their order, and a bf16
# output on a rounding boundary may round the other way, one bf16 ulp of
# the value, at most 2^-7 of max |plain|); f32 absolute (fp32 sums in
# another order)
SDPA_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}

# conv kernels, max |kernel - plain| / max |plain|: both sum exact fp32
# products in fp32, in other orders; bf16 output may then round the other
# way, by one bf16 ulp of the value, at most 2^-7 of max |plain|; f32 as
# the JAX suite's FP32_REL_TOL (tests/test_pallas_conv.py)
CONV_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
# fp32 sums of one term per pixel (the batch statistics, a dWeight) in
# other orders, relative to the sum of the terms' magnitudes (statistics)
# or to max |dw|: up to a few thousand pixels here
SUM_TOL = 1e-5
# bf16 training gradients through the kernels against autograd through the
# plain composition: relative L2 (bench_ops.py CONV_FUSED_REL_TOL, the JAX
# suite's BF16_GRAD_TOL)
BF16_GRAD_TOL = 0.03


def bwd_within_tol(got, ref, dtype):
    """max |got - ref| <= rel * max |ref| + abs, for each of dq, dk, dv."""
    rel, floor = BWD_TOL[dtype]
    return all((g.float() - r.float()).abs().max().item()
               <= rel * r.float().abs().max().item() + floor
               for g, r in zip(got, ref))


def shortseq_bwd_within_tol(got, ref, dtype):
    """SHORTSEQ_BWD_TOL per sequence, for each of dq, dk, dv."""
    rel, floor = SHORTSEQ_BWD_TOL[dtype]
    for g, r in zip(got, ref):
        err = (g.float() - r.float()).abs().amax((1, 2))
        if not bool((err <= rel * r.float().abs().amax((1, 2))
                     + floor).all()):
            return False
    return True


def shortseq_key_mask(B, H, S, kind):
    """None, or the additive fp32 key mask: `B` -> `[B, S]` (broadcast over
    heads) with padded tails of different lengths and sequence B - 1 all
    padding, at -1e30 as BertModel makes it; `BH` -> `[B * H, S]`, each
    head its own tail."""
    if kind is None:
        return None
    rows = B if kind == "B" else B * H
    lens = [S - (37 * i) % S for i in range(rows)]
    lens[-1] = 0
    keep = torch.arange(S, device="cuda")[None] < torch.tensor(
        lens, device="cuda")[:, None]
    return torch.where(keep, 0.0, -1e30).float().contiguous()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_paged_decode_kernel_matches_plain(card, dtype, D, bs):
    slots, heads, L, maxb = 5, 3, 2, 8
    positions = [0, bs - 1, bs, 3 * bs + 5, maxb * bs - 1]
    tables = torch.zeros((slots, maxb), dtype=torch.int32)
    nxt = 1
    for s, p in enumerate(positions[1:], 1):
        nb = p // bs + 1
        tables[s, :nb] = torch.arange(nxt, nxt + nb)
        nxt += nb
    tables[3, 0] = tables[4, 0]                  # a block read by two slots
    kp = torch.randn((L, nxt, bs, heads, D), generator=card,
                     device="cuda").to(dtype)
    vp = torch.randn_like(kp, dtype=torch.float32).to(dtype)
    q, kn, vn = (torch.randn((slots, 1, heads, D), generator=card,
                             device="cuda").to(dtype) for _ in range(3))
    tb = tables.cuda()
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    k0, v0, k1, v1 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    ref = paged_decode_plain(q, kn, vn, k0, v0, 1, tb, pos)
    launches = paged_decode_attention.launches
    out = paged_decode_attention(q, kn, vn, k1, v1, 1, tb, pos)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == launches + 1
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(k0, k1) and torch.equal(v0, v1)


def window_case(g, W, bs, D, dtype, int8):
    """Six slots over tables of 8 blocks, 3 heads, 2 layers: an idle lane;
    a window starting in the slot's first block and crossing into the
    second; draft length 0; a dead last row; a window ending at the
    table's last position (dead rows past the table); a window crossing a
    block in a slot reading another slot's first two blocks read-only.
    W = 1 is the decode step (positions 0, bs-2, bs+3, ...). int8 pools
    hold normal rows quantized on per-block grids 0.7-1.3x absmax/127.
    Returns (q, knew, vnew, kpool, vpool, scales or None, tables,
    positions, draft_lens, live rows)."""
    slots, heads, L, maxb = 6, 3, 2, 8
    K = W - 1
    last = maxb * bs - 1
    pos = [0, bs - 2, bs + 3, 3 * bs + 1, last - min(2, K), 4 * bs - 1]
    dlen = [0, K, 0, max(K - 1, 0), min(2, K), K]
    tables = torch.zeros((slots, maxb), dtype=torch.int32)
    nxt = 1
    for s in range(1, slots):
        nb = (pos[s] + dlen[s]) // bs + 1
        start = 0
        if s == 5:
            tables[s, :2] = tables[4, :2]
            start = 2
        tables[s, start:nb] = torch.arange(nxt, nxt + nb - start)
        nxt += nb - start
    dev = "cuda"
    shape = (L, nxt, bs, heads, D)
    kp, vp = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
    scales = None
    if int8:
        amax = torch.stack([kp.abs().amax((2, 3, 4)),
                            vp.abs().amax((2, 3, 4))], -1)
        scales = amax / 127 * (0.7 + 0.6 * torch.rand(
            amax.shape, generator=g, device=dev))
        kp, vp = (tpa._quant_rows(x, scales[..., i, None, None, None])
                  for i, x in enumerate((kp, vp)))
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    q, kn, vn = (torch.randn((slots, W, heads, D), generator=g,
                             device=dev).to(dtype) for _ in range(3))
    dl = torch.tensor(dlen, dtype=torch.int32)
    live = torch.arange(W)[None, :] <= dl[:, None]
    live[0] = False
    return (q, kn, vn, kp, vp, scales, tables.to(dev),
            torch.tensor(pos, dtype=torch.int32, device=dev), dl.to(dev),
            live.to(dev))


def _paged_kernel_vs_plain(kernel, plain, c, int8, layer=1):
    """Quantize once (int8), then run the plain version and the kernel on
    clones of the same pools; returns (max |out diff| on live rows, pools
    bit-identical outside block 0, scales untouched by both)."""
    q, kn, vn, kp, vp, sc, tb, pos, dl, live = c
    W = q.shape[1]
    if int8:
        if W == 1:
            kq, vq = tpa._quant_write_decode(kp, vp, sc, kn, vn, tb, pos,
                                             layer)
            kq, vq = kq[:, None], vq[:, None]
        else:
            kq, vq = tpa._quant_write_window(kp, vp, sc, kn, vn, tb, pos,
                                             dl, layer)
        kn, vn = kq.contiguous(), vq.contiguous()
    sc0 = None if sc is None else sc.clone()
    k0, v0, k1, v1 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    pre = ((sc[layer],) if int8 else ())
    post = (() if W == 1 else (dl,))
    ref = plain(q, kn, vn, k0, v0, *pre, layer, tb, pos, *post)
    launches = kernel.launches
    out = kernel(q, kn, vn, k1, v1, *pre, layer, tb, pos, *post)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    err = (out.float() - ref.float())[live].abs().max().item()
    pools = torch.equal(k0[:, 1:], k1[:, 1:]) and torch.equal(v0[:, 1:],
                                                              v1[:, 1:])
    return err, pools, sc is None or torch.equal(sc, sc0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
@pytest.mark.parametrize("W", [2, 5, 9])
def test_paged_verify_kernel_matches_plain(card, dtype, D, bs, W):
    c = window_case(card, W, bs, D, dtype, int8=False)
    err, pools, _ = _paged_kernel_vs_plain(paged_verify_attention,
                                           paged_verify_plain, c, False)
    assert err <= TOL[dtype] and pools


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
@pytest.mark.parametrize("W", [2, 5, 9])
def test_paged_verify_int8_kernel_matches_plain(card, dtype, D, bs, W):
    c = window_case(card, W, bs, D, dtype, int8=True)
    err, pools, scales = _paged_kernel_vs_plain(
        paged_verify_attention_int8, paged_verify_int8_plain, c, True)
    assert err <= TOL[dtype] and pools and scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_paged_decode_int8_kernel_matches_plain(card, dtype, D, bs):
    c = window_case(card, 1, bs, D, dtype, int8=True)
    err, pools, scales = _paged_kernel_vs_plain(
        paged_decode_attention_int8, paged_decode_int8_plain, c, True)
    assert err <= TOL[dtype] and pools and scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 63, 64, 129, 512])
def test_causal_kernel_matches_plain(card, dtype, D, S):
    q, k, v = (torch.randn((4, S, D), generator=card,
                           device="cuda").to(dtype) for _ in range(3))
    scale = 1.0 / math.sqrt(D)
    o_ref, l_ref = causal_attention_plain(q, k, v, scale)
    o, lse = causal_attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert (o.float() - o_ref.float()).abs().max().item() <= TOL[dtype]
    lse_tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    assert (lse - l_ref).abs().max().item() <= lse_tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 63, 64, 129, 512])
def test_causal_bwd_kernel_matches_plain(card, dtype, D, S):
    """dq, dk, dv of the kernel against the plain version from the same
    forward O and LSE, one launch counted, the same bits on a rerun."""
    q, k, v, do = (torch.randn((4, S, D), generator=card,
                               device="cuda").to(dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    o, lse = causal_attention_fwd(q, k, v, scale)
    ref = causal_attention_bwd_plain(q, k, v, o, do, lse, scale)
    launches = causal_attention_bwd.launches
    got = causal_attention_bwd(q, k, v, o, do, lse, scale)
    again = causal_attention_bwd(q, k, v, o, do, lse, scale)
    torch.cuda.synchronize()
    assert causal_attention_bwd.launches == launches + 2
    assert all(x.dtype == dtype and x.shape == q.shape for x in got)
    assert bwd_within_tol(got, ref, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [128, 256, 512])
@pytest.mark.parametrize("mask", [None, "B", "BH"])
def test_shortseq_kernel_matches_plain(card, dtype, D, S, mask):
    """O and LSE of the forward kernel (mask-free, a [B, S] mask broadcast
    over heads, a [BH, S] mask; padded tails and one all-padding sequence)
    against the plain version; the variant's own count moves."""
    B, H = 3, 2
    q, k, v = (torch.randn((B * H, S, D), generator=card,
                           device="cuda").to(dtype) for _ in range(3))
    km = shortseq_key_mask(B, H, S, mask)
    scale = 1.0 / math.sqrt(D)
    o_ref, l_ref = shortseq_attention_plain(q, k, v, scale, km)
    counts = (shortseq_attention_fwd.launches,
              shortseq_attention_fwd.masked_launches)
    o, lse = shortseq_attention_fwd(q, k, v, scale, km)
    torch.cuda.synchronize()
    masked = km is not None
    assert (shortseq_attention_fwd.launches - counts[0],
            shortseq_attention_fwd.masked_launches - counts[1]) == (
                int(not masked), int(masked))
    assert (o.float() - o_ref.float()).abs().max().item() <= TOL[dtype]
    lse_tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    assert (lse - l_ref).abs().max().item() <= lse_tol
    if masked:                 # the all-padding sequence: the mean of v
        last = slice((B - 1) * H, B * H) if mask == "B" else slice(-1, None)
        mean = v[last].float().mean(1, keepdim=True)
        assert (o[last].float() - mean).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [128, 256, 512])
@pytest.mark.parametrize("mask", [None, "B", "BH"])
def test_shortseq_bwd_kernel_matches_plain(card, dtype, D, S, mask):
    """dq, dk, dv of the backward kernel against the plain version from the
    kernel's forward O and LSE, one launch of the right variant counted,
    the same bits on a rerun."""
    B, H = 3, 2
    q, k, v, do = (torch.randn((B * H, S, D), generator=card,
                               device="cuda").to(dtype) for _ in range(4))
    km = shortseq_key_mask(B, H, S, mask)
    scale = 1.0 / math.sqrt(D)
    o, lse = shortseq_attention_fwd(q, k, v, scale, km)
    ref = shortseq_attention_bwd_plain(q, k, v, o, do, lse, scale, km)
    counts = (shortseq_attention_bwd.launches,
              shortseq_attention_bwd.masked_launches)
    got = shortseq_attention_bwd(q, k, v, o, do, lse, scale, km)
    again = shortseq_attention_bwd(q, k, v, o, do, lse, scale, km)
    torch.cuda.synchronize()
    masked = km is not None
    assert (shortseq_attention_bwd.launches - counts[0],
            shortseq_attention_bwd.masked_launches - counts[1]) == (
                2 * int(not masked), 2 * int(masked))
    assert all(x.dtype == dtype and x.shape == q.shape for x in got)
    assert shortseq_bwd_within_tol(got, ref, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_shortseq_attention_grads_through_the_kernels(card):
    """`shortseq_attention` in paddle layout with a [B, S] mask: autograd
    reaches the backward kernel's masked variant, the mask gets no
    gradient, and the gradients equal the plain backward's within tol."""
    B, S, H, D = 2, 256, 3, 64
    q, k, v = (torch.randn((B, S, H, D), generator=card, device="cuda")
               .requires_grad_() for _ in range(3))
    km = shortseq_key_mask(B, H, S, "B")
    km[-1, :100] = 0.0                     # no all-padding sequence here
    km.requires_grad_()
    do = torch.randn((B, S, H, D), generator=card, device="cuda")
    before = shortseq_attention_bwd.masked_launches
    out = shortseq_attention(q, k, v, key_mask=km)
    out.backward(do)
    assert shortseq_attention_bwd.masked_launches == before + 1
    assert km.grad is None

    def bh(x):
        return x.detach().transpose(1, 2).reshape(B * H, S, D).contiguous()

    scale = 1.0 / math.sqrt(D)
    o, lse = shortseq_attention_plain(bh(q), bh(k), bh(v), scale, km.detach())
    ref = shortseq_attention_bwd_plain(bh(q), bh(k), bh(v), o, bh(do), lse,
                                       scale, km.detach())
    got = [bh(x.grad) for x in (q, k, v)]
    assert shortseq_bwd_within_tol(got, ref, torch.float32)


def sdpa_within_tol(o, ref, dtype):
    err = (o.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item() if dtype == torch.bfloat16 else 1.0
    return err <= SDPA_TOL[dtype] * top


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("Sq,Skv,causal", [
    (1, 1, True), (63, 63, True), (130, 130, True), (512, 512, False),
    (64, 300, False), (257, 128, False), (1, 77, False)])
def test_sdpa_forward_kernel_matches_plain(card, dtype, D, Sq, Skv, causal):
    """B6 against its plain version, one launch a call, no plain call, the
    same bits on a rerun (no atomics)."""
    q = torch.randn((3, Sq, D), generator=card, device="cuda").to(dtype)
    k, v = (torch.randn((3, Skv, D), generator=card, device="cuda").to(dtype)
            for _ in range(2))
    scale = 1.0 / math.sqrt(D)
    ref = sdpa_forward_plain(q, k, v, scale, causal)
    launches, plain = sdpa_forward.launches, sdpa_forward.plain_calls
    o = sdpa_forward(q, k, v, scale, causal)
    again = sdpa_forward(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert (sdpa_forward.launches - launches,
            sdpa_forward.plain_calls - plain) == (2, 0)
    assert o.dtype == dtype and o.shape == q.shape
    assert torch.equal(o, again)
    assert sdpa_within_tol(o, ref, dtype)


def test_pallas_sdpa_forward_on_the_card(card):
    """The JAX entry point's port at B2 S256 H2 D128, causal and not: one
    kernel launch, its output in paddle layout against the plain version
    on the same `[BH, S, D]` rows; the block assert holds on the card
    too."""
    q, k, v = (torch.randn((2, 256, 2, 128), generator=card, device="cuda")
               for _ in range(3))

    def bh(x):
        return x.transpose(1, 2).reshape(4, 256, 128).contiguous()

    for causal in (True, False):
        launches = sdpa_forward.launches
        got = pallas_sdpa_forward(q, k, v, causal=causal, block_q=128)
        assert sdpa_forward.launches == launches + 1
        ref = sdpa_forward_plain(bh(q), bh(k), bh(v), 1.0 / math.sqrt(128),
                                 causal)
        assert sdpa_within_tol(bh(got), ref, torch.float32)
    with pytest.raises(AssertionError):
        pallas_sdpa_forward(q, k, v, block_q=96)


def test_sdpa_forward_refuses_what_it_does_not_take(card):
    z = torch.zeros((2, 128, 64), device="cuda")
    for q, k, match in (
            (torch.zeros((2, 128, 320), device="cuda"),) * 2 + ("256",),
            (torch.zeros((2, 128, 96), device="cuda"),) * 2 + ("head_dim",),
            (z.half(), z.half(), "dtype"),
            (z.transpose(0, 1), z.transpose(0, 1), "contiguous"),
            (z, z.bfloat16(), "share"),
            (z, torch.zeros((3, 128, 64), device="cuda"), "share"),
            (z, z.cpu(), "card")):
        with pytest.raises(ValueError, match=match):
            sdpa_forward(q, k, k)
    with pytest.raises(ValueError, match="Sq == Skv"):
        sdpa_forward(z, torch.zeros((2, 256, 64), device="cuda"),
                     torch.zeros((2, 256, 64), device="cuda"), causal=True)


def test_flash_attention_routes_on_the_card(card):
    """Non-causal shortseq shapes launch the shortseq kernel; non-causal
    library shapes launch B6 when no gradient is needed and raise naming
    the library route's backward when one is; head dim 320 raises naming
    B6's limit; shapes no kernel takes are dense."""
    x = torch.randn((2, 256, 2, 64), generator=card, device="cuda")
    before = shortseq_attention_fwd.launches
    flash_attention(x, x, x, causal=False)
    assert shortseq_attention_fwd.launches == before + 1
    z = torch.randn((1, 1024, 2, 64), generator=card, device="cuda")
    launches = sdpa_forward.launches
    got = flash_attention(z, z, z, causal=False)
    assert sdpa_forward.launches == launches + 1
    assert (got.cpu() - flash_attention(z.cpu(), z.cpu(), z.cpu(),
                                        causal=False)).abs().max() <= 1e-5
    zg = z.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention(zg, zg, zg, causal=False)
    with torch.no_grad():
        flash_attention(zg, zg, zg, causal=False)
    assert sdpa_forward.launches == launches + 2
    z320 = torch.zeros((1, 128, 1, 320), device="cuda")
    with pytest.raises(ValueError, match="256"):
        flash_attention(z320, z320, z320, causal=False)
    dense = flash_attention.dense_calls
    z = torch.zeros((1, 96, 2, 64), device="cuda")
    assert flash_attention(z, z, z, causal=False).shape == z.shape
    assert flash_attention.dense_calls == dense + 1


def test_shortseq_kernels_refuse_what_they_do_not_take(card):
    z = torch.zeros((2, 256, 64), device="cuda")
    lse = torch.zeros((2, 256), device="cuda")
    for bad in (torch.zeros((2, 192, 64), device="cuda"),
                torch.zeros((2, 1024, 64), device="cuda")):
        with pytest.raises(ValueError, match="S="):
            shortseq_attention_fwd(bad, bad, bad)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros((2, 256, 96), device="cuda")
        shortseq_attention_fwd(x, x, x)
    for km in (torch.zeros((2, 256), device="cuda", dtype=torch.bfloat16),
               torch.zeros((3, 256), device="cuda"),
               torch.zeros((2, 128), device="cuda"),
               torch.zeros((2, 256)),
               torch.zeros((256, 2), device="cuda").t()):
        with pytest.raises(ValueError, match="key_mask"):
            shortseq_attention_fwd(z, z, z, key_mask=km)
        with pytest.raises(ValueError, match="key_mask"):
            shortseq_attention_bwd(z, z, z, z, z, lse, key_mask=km)
    with pytest.raises(ValueError, match="lse"):
        shortseq_attention_bwd(z, z, z, z, z, lse[:, :128].contiguous())


def test_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros((2, 1, 2, 96), device="cuda")
    pool = torch.zeros((1, 4, 16, 2, 96), device="cuda")
    tb = torch.zeros((2, 4), dtype=torch.int32, device="cuda")
    pos = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention(q, q, q, pool, pool.clone(), 0, tb, pos)
    q = torch.zeros((2, 1, 2, 64), device="cuda")
    pool = torch.zeros((1, 4, 12, 2, 64), device="cuda")
    with pytest.raises(ValueError, match="block_size"):
        paged_decode_attention(q, q, q, pool, pool.clone(), 0, tb, pos)
    x = torch.zeros((2, 8, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        causal_attention_fwd(x, x, x)
    z = torch.zeros((2, 8, 64), device="cuda")
    lse = torch.zeros((2, 8), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros((2, 8, 96), device="cuda")
        causal_attention_bwd(x, x, x, x, x, lse)
    with pytest.raises(ValueError, match="dtype"):
        x = z.half()
        causal_attention_bwd(x, x, x, x, x, lse)
    with pytest.raises(ValueError, match="contiguous"):
        causal_attention_bwd(z, z, z, z, z.transpose(0, 1).contiguous()
                             .transpose(0, 1), lse)
    with pytest.raises(ValueError, match="lse"):
        causal_attention_bwd(z, z, z, z, z, lse.to(torch.bfloat16))
    with pytest.raises(ValueError, match="the card"):
        causal_attention_bwd(z, z, z, z, z.cpu(), lse)
    # verify: a window wider than 9 rows, one row, an int8 pool without
    # its scale plane's shape
    tb = torch.zeros((2, 4), dtype=torch.int32, device="cuda")
    pool = torch.zeros((1, 4, 16, 2, 64), device="cuda")
    for W in (10, 1):
        q = torch.zeros((2, W, 2, 64), device="cuda")
        with pytest.raises(ValueError, match="rows per slot"):
            paged_verify_attention(q, q, q, pool, pool.clone(), 0, tb, pos,
                                   pos)
    q = torch.zeros((2, 3, 2, 64), device="cuda")
    codes = torch.zeros((2, 3, 2, 64), dtype=torch.int8, device="cuda")
    ipool = torch.zeros((1, 4, 16, 2, 64), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="kv_scales"):
        paged_verify_attention_int8(q, codes, codes, ipool, ipool.clone(),
                                    torch.zeros((3, 2), device="cuda"), 0,
                                    tb, pos, pos)
    with pytest.raises(ValueError, match="int8"):
        paged_decode_attention_int8(q[:, :1], q[:, :1], q[:, :1], pool,
                                    pool.clone(),
                                    torch.zeros((4, 2), device="cuda"), 0,
                                    tb, pos)


def conv_case(g, N, H, W, cin, cout, k, dtype):
    """x NHWC, the view of a channels_last NCHW tensor (as ConvBNReLU hands
    it over), w HWIO, fp32 scale and shift."""
    x = torch.randn((N, cin, H, W), generator=g, device="cuda").to(dtype) \
        .contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    w = (torch.randn((k, k, cin, cout), generator=g, device="cuda")
         * 0.1).to(dtype)
    scale = torch.rand(cout, generator=g, device="cuda") + 0.5
    shift = torch.randn(cout, generator=g, device="cuda")
    return x, w, scale, shift


def conv_rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-6)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("padding", ["int", "SAME"])
@pytest.mark.parametrize("shape", [(3, 7, 7, 24, 72), (2, 28, 19, 64, 136)],
                         ids=["M147", "M1064-or-266"])
def test_conv_kernels_match_plain(card, dtype, k, stride, relu, padding,
                                  shape):
    """B7 and B8 against the plain version: M not a multiple of the 128-row
    tile, Cout not a multiple of 64, odd widths (SAME's asymmetric halo at
    stride 2), int padding (1 for 3x3, 0 for 1x1)."""
    N, H, W, cin, cout = shape
    x, w, scale, shift = conv_case(card, N, H, W, cin, cout, k, dtype)
    pad = "SAME" if padding == "SAME" else (1 if k == 3 else 0)
    wrapper = conv1x1_bn_relu if k == 1 else conv3x3_bn_relu
    before = wrapper.launches
    got = fused_conv_bn_relu(x, w, scale, shift, stride, pad, relu)
    ref = conv_bn_relu_plain(x, w, scale, shift, stride, pad, relu)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert got.shape == ref.shape and got.dtype == dtype
    assert got.is_contiguous()
    assert conv_rel_err(got, ref) <= CONV_TOL[dtype]
    if not relu:
        assert bool((got < 0).any())


def test_conv_kernels_at_stage_widths(card):
    """A ResNet stage-4 3x3 (512 channels, 4608-long reduction) and the
    stage-1 1x1 64 -> 256, bf16 and f32."""
    for dtype in (torch.float32, torch.bfloat16):
        for H, cin, cout, k, s in ((7, 512, 512, 3, 1), (14, 64, 256, 1, 1),
                                   (14, 256, 512, 1, 2)):
            x, w, scale, shift = conv_case(card, 4, H, H, cin, cout, k,
                                           dtype)
            pad = 1 if k == 3 else 0
            got = fused_conv_bn_relu(x, w, scale, shift, s, pad)
            ref = conv_bn_relu_plain(x, w, scale, shift, s, pad)
            assert conv_rel_err(got, ref) <= CONV_TOL[dtype], (H, cin, k)


def test_conv_kernels_refuse_what_they_do_not_take(card):
    x, w, scale, shift = conv_case(card, 2, 8, 8, 16, 16, 3, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        # NHWC view of an NCHW-contiguous tensor
        conv3x3_bn_relu(x.permute(0, 3, 1, 2).contiguous()
                        .permute(0, 2, 3, 1), w, scale, shift, 1, 1)
    with pytest.raises(ValueError, match="bfloat16"):
        conv3x3_bn_relu(x, w.to(torch.bfloat16), scale, shift, 1, 1)
    with pytest.raises(ValueError, match="float32"):
        conv3x3_bn_relu(x, w, scale.to(torch.bfloat16), shift, 1, 1)
    with pytest.raises(ValueError, match="is on"):
        conv3x3_bn_relu(x, w, scale.cpu(), shift, 1, 1)
    with pytest.raises(ValueError, match="do not cover"):
        x12, w12, s12, b12 = conv_case(card, 2, 8, 8, 12, 16, 3,
                                       torch.float32)
        conv3x3_bn_relu(x12, w12, s12, b12, 1, 1)
    with pytest.raises(ValueError, match="do not cover"):
        conv1x1_bn_relu(x, w[:1, :1], scale, shift, 1, 1)   # padded 1x1
    with pytest.raises(ValueError, match="takes a 1x1"):
        conv1x1_bn_relu(x, w, scale, shift, 1, 1)


def test_resnet_on_the_card_matches_the_cpu(card):
    """resnet18, f32, from the same weights: every block conv through the
    kernels on the card (8 x 2 3x3, 3 downsample 1x1), none through a plain
    version; the logits against the plain versions on the CPU."""
    from paddle_tpu_torch import resnet18

    model = resnet18(num_classes=10, device="cuda", generator=card).eval()
    host = resnet18(num_classes=10, device="cpu").eval()
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x = torch.rand((2, 3, 32, 32), generator=card, device="cuda") * 2 - 1
    counts = [(w.launches, w.plain_calls)
              for w in (conv1x1_bn_relu, conv3x3_bn_relu)]
    with torch.no_grad():
        got = model(x)
        torch.cuda.synchronize()
        assert [(w.launches - a, w.plain_calls - b) for w, (a, b) in zip(
            (conv1x1_bn_relu, conv3x3_bn_relu), counts)] == [(3, 0), (16, 0)]
        ref = host(x.cpu())
    assert conv_rel_err(got.cpu(), ref) <= 1e-5


def test_causal_flash_attention_routes_on_the_card(card):
    """Causal self-attention in JAX's order (ROADMAP Queue C 8): head dim
    64 launches the causal kernel; head dim 16 computes densely instead of
    raising (dense_attention's result, counted); a library shape (S 128, D
    192) launches B6 without a gradient and raises naming the backward
    with one; a tiny GPT (head dim 16) takes a train step on the card with
    a finite loss."""
    from paddle_tpu_torch import AdamW, GPTConfig, GPTForCausalLM, TrainStep
    from paddle_tpu_torch.ops.flash_attention import dense_attention

    x = torch.randn((1, 64, 2, 64), generator=card, device="cuda")
    before = causal_attention_fwd.launches
    flash_attention(x, x, x, causal=True)
    assert causal_attention_fwd.launches == before + 1
    y = torch.randn((2, 48, 2, 16), generator=card, device="cuda")
    dense = flash_attention.dense_calls
    got = flash_attention(y, y, y, causal=True)
    assert flash_attention.dense_calls == dense + 1
    torch.testing.assert_close(got, dense_attention(y, y, y, True),
                               rtol=0, atol=0)
    z = torch.randn((1, 128, 1, 192), generator=card, device="cuda")
    launches = sdpa_forward.launches
    with torch.inference_mode():
        got = flash_attention(z, z, z, causal=True)
    assert sdpa_forward.launches == launches + 1
    assert (got.cpu() - flash_attention(z.cpu(), z.cpu(), z.cpu(),
                                        causal=True)).abs().max() <= 1e-5
    zg = z.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention(zg, zg, zg, causal=True)
    model = GPTForCausalLM(GPTConfig.tiny(vocab=61, hidden=32, heads=2),
                           device="cuda", generator=card)
    step = TrainStep(model, AdamW(1e-3, parameters=model.parameters()),
                     model.loss_fn)
    ids = torch.randint(0, 61, (2, 16), generator=card, device="cuda")
    assert math.isfinite(float(step(ids, ids)))


def test_engine_serves_a_narrow_head_on_the_card(card):
    """An engine at head dim 32 (ROADMAP Queue C 9): `auto` resolves dense,
    serves greedily on the card through the plain dense paged path, and
    equals `generate(use_cache=True)`; an explicit `pallas` is the kernel,
    which refuses the head dim."""
    from paddle_tpu_torch import GenerationEngine, GPTConfig, GPTForCausalLM

    model = GPTForCausalLM(GPTConfig.tiny(vocab=61, hidden=64, heads=2),
                           device="cuda", generator=card).eval()
    eng = GenerationEngine(model, num_slots=2, block_size=8)
    assert eng.attention_backend == "dense"
    dense = tpa.paged_attention_step.dense_calls
    prompt = [3, 14, 15, 9, 26, 5, 35]
    rid = eng.add_request(prompt, 12)
    out = eng.run()[rid]
    assert tpa.paged_attention_step.dense_calls > dense
    ref = model.generate(torch.tensor([prompt], device="cuda"),
                         max_length=len(prompt) + 12, use_cache=True)
    assert list(out) == ref[0].tolist()
    eng = GenerationEngine(model, num_slots=2, block_size=8,
                           attention_backend="pallas")
    eng.add_request(prompt, 4)
    with pytest.raises(ValueError, match="head_dim"):
        eng.run()


def sums_rel_err(got, ref, mag):
    """max |got - ref| over each row of [2, Cout] sums, relative to the sum
    of the magnitudes of its terms (`mag`)."""
    return ((got - ref).abs() / mag.clamp_min(1e-6)).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["int", "SAME"])
@pytest.mark.parametrize("shape", [(3, 7, 7, 24, 72), (2, 28, 19, 64, 136)],
                         ids=["M147", "M1064-or-266"])
def test_conv_train_kernels_match_plain(card, dtype, k, stride, padding,
                                        shape):
    """B9a and B9b against `conv_train_plain`: the conv within CONV_TOL and
    both rows of its [2, Cout] sums within SUM_TOL of the sum of the
    terms' magnitudes (bf16: a cast value may round the other way, one
    ulp of that value, so 2^-7)."""
    N, H, W, cin, cout = shape
    x, w, _, _ = conv_case(card, N, H, W, cin, cout, k, dtype)
    pad = "SAME" if padding == "SAME" else (1 if k == 3 else 0)
    if k == 1 and pad == "SAME" and stride == 2:
        pad = 0                                  # SAME k=1 is VALID
    wrapper = conv1x1_train if k == 1 else conv3x3_train
    before = wrapper.launches
    got, sums = (wrapper(x, w, stride) if k == 1
                 else wrapper(x, w, stride, pad))
    ref, ref_sums = conv_train_plain(x, w, stride, pad)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert got.shape == ref.shape and got.dtype == dtype
    assert sums.shape == (2, cout) and sums.dtype == torch.float32
    assert conv_rel_err(got, ref) <= CONV_TOL[dtype]
    p = ref.reshape(-1, cout).float()
    mag = torch.stack([p.abs().sum(0), (p * p).sum(0)])
    tol = SUM_TOL if dtype == torch.float32 else 2.0 ** -7
    assert sums_rel_err(sums, ref_sums, mag) <= tol


def bwd_bundle(g, cout, dtype):
    """An fp32 bundle [8, Cout] = [mean_n, inv_n, gamma, beta, mean32,
    rstd32, c1, c2], the *_n rows rounded through the compute dtype."""
    mean32 = torch.randn(cout, generator=g, device="cuda") * 0.3
    rstd32 = torch.rand(cout, generator=g, device="cuda") + 0.5
    gamma = torch.rand(cout, generator=g, device="cuda") + 0.5
    beta = torch.randn(cout, generator=g, device="cuda") * 0.5
    c1, c2 = (torch.randn(cout, generator=g, device="cuda") * 0.1
              for _ in range(2))
    return torch.stack([mean32.to(dtype).float(), rstd32.to(dtype).float(),
                        gamma, beta, mean32, rstd32, c1, c2]).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(3, 7, 7, 24, 72), (2, 28, 19, 64, 136),
                                   (2, 14, 14, 256, 64)],
                         ids=["M147", "M1064-or-266", "Cin256"])
def test_conv1x1_bwd_kernel_matches_plain(card, dtype, stride, relu, shape):
    """B10 against `conv1x1_bwd_plain` from the same bundle: dx within
    CONV_TOL (the same dConv bits, products summed in other orders, one
    cast) with zeros off the stride's sampled pixels, dw within SUM_TOL of
    max |dw|."""
    N, H, W, cin, cout = shape
    x, w, _, _ = conv_case(card, N, H, W, cin, cout, 1, dtype)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    y = torch.randn((N, Ho, Wo, cout), generator=card, device="cuda") \
        .to(dtype)
    dy = torch.randn((N, Ho, Wo, cout), generator=card, device="cuda") \
        .to(dtype)
    rows = bwd_bundle(card, cout, dtype)
    wt = w[0, 0].t().contiguous()
    before = conv1x1_bwd.launches
    dx, dw = conv1x1_bwd(x, dy, y, rows, wt, stride, relu)
    rdx, rdw = conv1x1_bwd_plain(x, dy, y, rows, wt, stride, relu)
    torch.cuda.synchronize()
    assert conv1x1_bwd.launches == before + 1
    assert dx.shape == x.shape and dx.dtype == dtype
    assert dw.shape == (cin, cout) and dw.dtype == torch.float32
    assert conv_rel_err(dx, rdx) <= CONV_TOL[dtype]
    if stride == 2:
        off = torch.ones_like(dx, dtype=torch.bool)
        off[:, ::2, ::2] = False
        assert bool((dx[off] == 0).all())
    assert conv_rel_err(dw, rdw) <= SUM_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["int", "SAME", "VALID"])
@pytest.mark.parametrize("shape", [(3, 7, 7, 24, 72), (2, 28, 19, 64, 136),
                                   (2, 7, 7, 512, 64)],
                         ids=["M147", "M1064-or-266", "Cin512"])
def test_conv3x3_dw_kernel_matches_plain(card, dtype, stride, padding,
                                         shape):
    """B11 against `conv3x3_dw_plain`: the nine taps' dw within SUM_TOL of
    max |dw|, with the halo of every padding read as zero."""
    N, H, W, cin, cout = shape
    x, _, _, _ = conv_case(card, N, H, W, cin, cout, 3, dtype)
    pad = 1 if padding == "int" else padding
    from paddle_tpu_torch.ops.conv import normalize_conv_padding

    (pt, pb), (pl, pr) = normalize_conv_padding(pad, 3, stride, (H, W))
    Ho, Wo = (H + pt + pb - 3) // stride + 1, (W + pl + pr - 3) // stride + 1
    g = torch.randn((N, Ho, Wo, cout), generator=card, device="cuda") \
        .to(dtype)
    before = conv3x3_dw.launches
    dw = conv3x3_dw(x, g, stride, pad)
    ref = conv3x3_dw_plain(x, g, stride, pad)
    torch.cuda.synchronize()
    assert conv3x3_dw.launches == before + 1
    assert dw.shape == (3, 3, cin, cout) and dw.dtype == torch.float32
    assert conv_rel_err(dw, ref) <= SUM_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,stride,relu,padding", [
    (1, 1, True, 0), (1, 2, False, 0), (3, 1, True, 1), (3, 2, True, 1),
    (3, 2, False, "SAME")])
def test_fused_train_grads_through_the_kernels(card, dtype, k, stride, relu,
                                               padding):
    """`fused_conv_bn_relu_train` through the kernels (one launch each of
    the train forward and of B10, or of B11 and the B8 dX walk). f32:
    against autograd through the plain composition
    `conv_bn_relu_train_plain` on the card, y, mean, var and the four
    gradients within 1e-5 of their largest value. bf16: against the same
    op on CPU copies of the inputs (its plain versions: the same
    algorithm, sums in other orders), y, mean and var within CONV_TOL and
    the gradients within BF16_GRAD_TOL relative L2. At bf16 the dense
    autograd is no yardstick here: its ReLU masks and BatchNorm backward
    round at other places, and on the CPU both it and the train op sit
    2-7 % (relative L2) from the fp32 gradients at these shapes."""
    x, w, _, _ = conv_case(card, 4, 15, 15, 32, 48, k, dtype)
    gamma = (torch.rand(48, generator=card, device="cuda") + 0.5).to(dtype)
    beta = torch.randn(48, generator=card, device="cuda").to(dtype)
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, w, gamma, beta)]
    kernels = ((conv1x1_train, conv1x1_bwd) if k == 1 else
               (conv3x3_train, conv3x3_dw, conv3x3_bn_relu))
    before = [(kk.launches, kk.plain_calls) for kk in kernels]
    y, mean, var = fused_conv_bn_relu_train(*leaves, stride=stride,
                                            padding=padding, relu=relu)
    dy = torch.randn(y.shape, generator=card, device="cuda").to(y.dtype)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert [(kk.launches - a, kk.plain_calls - b)
            for kk, (a, b) in zip(kernels, before)] == [(1, 0)] * len(kernels)
    if dtype == torch.float32:
        ref_leaves = [t.detach().clone().requires_grad_()
                      for t in (x, w, gamma, beta)]
        ref = conv_bn_relu_train_plain(*ref_leaves, stride=stride,
                                       padding=padding, relu=relu)
        rgrads = torch.autograd.grad(ref[0], ref_leaves, dy)
    else:
        ref_leaves = [t.detach().cpu().contiguous().requires_grad_()
                      for t in (x, w, gamma, beta)]
        ref = fused_conv_bn_relu_train(*ref_leaves, stride=stride,
                                       padding=padding, relu=relu)
        rgrads = torch.autograd.grad(ref[0], ref_leaves, dy.cpu())
    for got, r in zip((y, mean, var), ref):
        assert conv_rel_err(got.cpu(), r.cpu()) <= CONV_TOL[dtype]
    for name, got, r in zip(("dx", "dw", "dgamma", "dbeta"), grads, rgrads):
        assert got.dtype == r.dtype, name
        got, r = got.cpu(), r.cpu()
        if dtype == torch.float32:
            assert conv_rel_err(got, r) <= 1e-5, name
        else:
            err = ((got.float() - r.float()).norm() / r.float().norm()).item()
            assert err <= BF16_GRAD_TOL, name


def test_conv_train_kernels_refuse_what_they_do_not_take(card):
    x, w, _, _ = conv_case(card, 2, 8, 8, 16, 16, 3, torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        conv3x3_train(x, w.to(torch.bfloat16), 1, 1)
    with pytest.raises(ValueError, match="takes a 1x1"):
        conv1x1_train(x, w, 1)
    g = torch.zeros((2, 8, 8, 16), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        conv3x3_dw(x, g, 1, 1)
    y = torch.zeros((2, 8, 8, 16), device="cuda")
    rows = torch.zeros((8, 16), device="cuda")
    with pytest.raises(ValueError, match="rows"):
        conv1x1_bwd(x, y, y, rows.to(torch.bfloat16), w[0, 0], 1)
    with pytest.raises(ValueError, match="contiguous"):
        conv1x1_bwd(x, y.permute(0, 2, 1, 3), y, rows, w[0, 0], 1)


def test_resnet50_train_step_on_the_card_matches_the_cpu(card):
    """resnet50(num_classes=10), f32, batch 2 at 64 x 64, one TrainStep
    with Momentum(0.1, 0.9) from the same weights: on the card every
    bottleneck and downsample conv trains through the kernels (36 1x1 and
    16 3x3 train forwards, 36 1x1 backwards, 16 3x3 dWeights, 16 B8 dX
    walks) and none through a plain version; against the plain versions
    on the CPU the loss is within 2e-4 and the gradients within 0.3
    (relative L2 over all parameters): a ResNet-50 in train mode at random
    init amplifies fp32 rounding ~1000x by layer4, so two fp32
    implementations that sum in other orders differ this much
    (tests/test_torch_resnet_train.py measures it)."""
    from paddle_tpu_torch import Momentum, TrainStep, resnet50
    from paddle_tpu_torch.ops.nn_ops import cross_entropy

    model = resnet50(num_classes=10, device="cuda", generator=card)
    host = resnet50(num_classes=10, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x = torch.rand((2, 3, 64, 64), generator=card, device="cuda") * 2 - 1
    y = torch.randint(0, 10, (2,), generator=card, device="cuda")
    kernels = (conv1x1_train, conv3x3_train, conv1x1_bwd, conv3x3_dw,
               conv3x3_bn_relu)
    losses, grads = [], []
    for m, xx, yy in ((model, x, y), (host, x.cpu(), y.cpu())):
        opt = Momentum(0.1, 0.9, parameters=m.parameters())
        before = [(kk.launches, kk.plain_calls) for kk in kernels]
        losses.append(float(TrainStep(m, opt, cross_entropy)(xx, yy)))
        if m is model:
            torch.cuda.synchronize()
            assert [(kk.launches - a, kk.plain_calls - b) for kk, (a, b)
                    in zip(kernels, before)] == \
                [(36, 0), (16, 0), (36, 0), (16, 0), (16, 0)]
        grads.append(torch.cat([v.flatten().cpu() for v in
                                opt._accumulators["velocity"]]))
    assert abs(losses[0] - losses[1]) <= 2e-4 * abs(losses[1])
    assert ((grads[0] - grads[1]).norm() / grads[1].norm()).item() <= 0.3


def test_transformer_on_the_card_matches_the_cpu(card):
    """nn.Transformer(128, 2 heads, 2 + 2 layers, FFN 256), f32, from the
    same weights, a source of 640 and a target of 128 under the causal
    mask: B6 launches 4 times (the encoder self-attentions and the
    cross-attentions), no plain call, nothing dense through
    `flash_attention`; the output against the CPU within 1e-5 relative
    L2."""
    from paddle_tpu_torch import Transformer

    model = Transformer(128, 2, 2, 2, 256, 0.0, device="cuda",
                        generator=card).eval()
    host = Transformer(128, 2, 2, 2, 256, 0.0, device="cpu").eval()
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    src = torch.rand((2, 640, 128), generator=card, device="cuda") * 2 - 1
    tgt = torch.rand((2, 128, 128), generator=card, device="cuda") * 2 - 1
    mask = Transformer.generate_square_subsequent_mask(128)
    launches, plain = sdpa_forward.launches, sdpa_forward.plain_calls
    dense = flash_attention.dense_calls
    with torch.inference_mode():
        got = model(src, tgt, tgt_mask=mask)
        torch.cuda.synchronize()
        assert (sdpa_forward.launches - launches,
                sdpa_forward.plain_calls - plain,
                flash_attention.dense_calls - dense) == (4, 0, 0)
        ref = host(src.cpu(), tgt.cpu(), tgt_mask=mask.cpu())
    assert ((got.cpu() - ref).norm() / ref.norm()).item() <= 1e-5
