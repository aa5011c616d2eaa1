"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where there is no CUDA device (a CUDA kernel has no
interpret mode). On a machine with a card, without jax installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

This file imports nothing of jax or paddle_tpu. chip_smoke.py holds the
kernels at the serving and training shapes; these cover the other head
dims, lengths, block sizes and window widths the kernels take.

Conv kernels (B7, B8): against `conv_bn_relu_plain` on the card with
TF32 off, max |kernel - plain| relative to max |plain| (CONV_TOL); the
ResNet on the card against the same ResNet on the CPU.

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
    shortseq_attention_plain, flash_attention)
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.conv import (conv1x1_bn_relu, conv3x3_bn_relu,
                                       conv_bn_relu_plain, fused_conv_bn_relu)
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

# conv kernels, max |kernel - plain| / max |plain|: both sum exact fp32
# products in fp32, in other orders; bf16 output may then round the other
# way, by one bf16 ulp of the value, at most 2^-7 of max |plain|; f32 as
# the JAX suite's FP32_REL_TOL (tests/test_pallas_conv.py)
CONV_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


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


def test_flash_attention_routes_on_the_card(card):
    """Non-causal shortseq shapes launch the shortseq kernel; non-causal
    shapes that wait for the flash forward kernel B6 raise on the card;
    shapes no kernel takes are dense."""
    x = torch.randn((2, 256, 2, 64), generator=card, device="cuda")
    before = shortseq_attention_fwd.launches
    flash_attention(x, x, x, causal=False)
    assert shortseq_attention_fwd.launches == before + 1
    z = torch.zeros((1, 1024, 2, 64), device="cuda")
    with pytest.raises(NotImplementedError, match="B6"):
        flash_attention(z, z, z, causal=False)
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
