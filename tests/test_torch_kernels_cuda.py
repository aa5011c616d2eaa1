"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where there is no CUDA device (a CUDA kernel has no
interpret mode). On a machine with a card, without jax installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

This file imports nothing of jax or paddle_tpu. chip_smoke.py holds the
kernels at the serving and training shapes; these cover the other head
dims, lengths, block sizes and window widths the kernels take. The causal
pair (bf16 on the tensor cores, f32 in fp32 FMA) runs at the tile edges of
both designs and at a BH of 1 as well as 4; both refuse a misaligned view.

The shortseq forward B12 (bf16 on the tensor cores in two passes, f32 in
fp32 FMA) at every S it takes, a rerun giving the same bits, and with
peaked logits (q scaled by 8), where a wrong row max shows. The shortseq
backward B13 (the causal backward's source without the causal mask, with
the key mask: bf16 on the tensor cores, f32 in fp32 FMA) at every D and
S, mask-free and with both mask layouts and an all-padding sequence.

The flash forward B6 (`sdpa_forward`): against `sdpa_forward_plain` at each
dtype and head dim (64 to 256), causal and not, Sq == Skv and Sq != Skv,
ragged lengths; with peaked logits and a ragged key tail, where a wrong
online rescale or an unmasked tail key shows; its refusals; `flash_attention`'s library route (B6 with
no gradient, B6's LSE variant and the library backward with one); a
Transformer on the card against the same Transformer on the CPU. B6's LSE
variant and the library route's backward (`sdpa_backward`, bf16 on
wgmma fed by TMA to D 256, the wide FMA design for f32 and D 320-512)
against their plain versions at every head dim to 512, ragged Sq != Skv
both ways and causal, and the wgmma design off its 64- and 128-row tiles
at several heads, at B2's bars; a Transformer train step through them.

The one-pass optimizer update against the per-parameter loop it replaces
(run on the same card): AdamW with a parameter that does not decay, Adam
with and without L2, Momentum with and without Nesterov and weight decay,
SGD, Adagrad, RMSProp (centered too), Adadelta, Adam and AdamW with bf16
moments, f32, bf16 and both in one optimizer, bit for bit over three
steps; Lars and Lamb (the norm pass, then the update) within a tolerance
and bitwise deterministic. Gradient merge's kernels (merge, finish,
unscale) bit for bit against their plain versions, flags included, their
refusals, and a TrainStep with merge and a scaler counting their
launches.

Conv kernels (B7, B8; bf16 on the tensor cores, f32 in fp32 FMA): against
`conv_bn_relu_plain` on the card with TF32 off, max |kernel - plain|
relative to max |plain| (CONV_TOL), B7 also at every 1x1 of ResNet-50 and
at ragged tiles; the ResNet on the card against the same ResNet on the
CPU. The conv training
kernels (B9a/B9b train forwards, B10 1x1 backward, B11 3x3 dWeight; all
four and B8 bf16 on the tensor cores, B9b also where its tile holds fewer
than 128 pixels, the partial buffer sized to the tile and a smaller one
refused, B11 also at the seven sweep shapes
against an fp64 reference, B10 at Cout 2048 and across pixel splits, B8
at Cin 512 stride 2, at rows wider than a tile and as the stride-2 dX
walk) against their plain versions over dtype x stride x shape, the training
op's gradients through the kernels against autograd through the plain
composition, and a ResNet-50 train step on the card against the CPU.

The sampler's draws (`sample_draw`, and `verify_draws`, the draw and the
acceptance coin in one launch): tokens and coins
bit for bit the plain versions' on the card, at the serving shapes and at
odd N and V tails (N 1 to 4,096, V not a multiple of four times the
draw's cluster, rows off 16-byte boundaries), with and without excluded
indices; the sampled engine
on the card emitting the CPU engine's streams. The int8-weight linear
(`int8_linear`, bf16 on the tensor cores with K split over a cluster,
f32 in fp32 FMA) against its plain version at odd M, N and K tails and
GPT-1.3B's shapes, every split its plan takes with each half of N bitwise
the whole launch's columns, its refusals, and the int8-weight engine
launching it four times a layer.

The batched LoRA kernel (`batched_lora`, fp32 FMA, a slot's shrink split
over a cluster): its fp32 delta (the f32 instance over a zero base) against
the plain version's, the bf16 result bitwise the plain version's wherever
the two fp32 deltas round to the same bf16, null-page rows bitwise the
base, a rerun the same bits, at ranks 1 to 64, 1 to 300 rows a slot, the
qkv site's head-grouped pages at 1 and 4 heads, ragged row and column
tiles, in_dim off a multiple of 8 and an unaligned x (the plain-load
route), an all-null batch, shards bitwise the whole launch; its refusals;
a LoRA engine on the card emitting the CPU
engine's tokens and launching the kernel four times a layer a step. The
causal kernel B1 at the bucket ladder's short buckets (S 16, 32, 48) and a
bucketed engine launching it once a layer an admission. The engine's async
core on the card: its stages after the dispatch make no host sync
(`set_sync_debug_mode("error")`), and its tokens and launches are the
serial core's, at K=0, with sampled lanes at K=2, with int8 KV and with
adapters that prefetch.

Paged kernels: pools must be bit-identical to the plain version's outside
the null block 0, and outputs within tolerance on the live rows of live
slots. The decode and verify kernels on bf16 and int8 pools (the split
walk) also at contexts up to 2047 keys at every block size, and twice to
the same bits; decode's pools whole, block 0 included. Block 0 is a race, not a reference: idle lanes and dead window rows
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
    sdpa_backward, sdpa_backward_plain, sdpa_forward, sdpa_forward_plain)
from paddle_tpu_torch.ops.optimizer_update import (optimizer_update,
                                                   optimizer_update_plain)
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.conv import (
    conv1x1_bn_relu, conv1x1_bwd, conv1x1_bwd_plain, conv1x1_train,
    conv3x3_bn_relu, conv3x3_dw, conv3x3_dw_plain, conv3x3_train,
    conv_bn_relu_plain, conv_bn_relu_train_plain, conv_train_partial_rows,
    conv_train_plain, fused_conv_bn_relu, fused_conv_bn_relu_train, _bind)
from paddle_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                               paged_decode_attention_int8,
                                               paged_decode_int8_plain,
                                               paged_decode_plain)
from paddle_tpu_torch.ops.paged_verify import (paged_verify_attention,
                                               paged_verify_attention_int8,
                                               paged_verify_int8_plain,
                                               paged_verify_plain)
from paddle_tpu_torch.ops.int8_linear import int8_linear, int8_linear_plain
from paddle_tpu_torch.ops.lora import (LORA_MAX_RANK, batched_lora,
                                       batched_lora_plain)
from paddle_tpu_torch.ops.sampling import (SALT_ACCEPT, SALT_SAMPLE,
                                           sample_draw, sample_draw_plain,
                                           sample_uniform_plain,
                                           verify_draws)
from paddle_tpu_torch.quantization import quantize_absmax

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

# shortseq forward with peaked logits, per sequence as SHORTSEQ_BWD_TOL,
# over O: bf16 relative to the slab's max |O| (O is then close to single
# rows of v, up to ~4, where one bf16 ulp is 2^-5 and a value on a rounding
# boundary may round the other way: at most 2^-7 of the value), f32
# absolute (chip_smoke.py's SHORTSEQ_FWD_TOL)
SHORTSEQ_FWD_TOL = {torch.bfloat16: (1e-2, 1e-5), torch.float32: (0.0, 1e-5)}

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


def window_case(g, W, bs, D, dtype, int8, heads=3):
    """Six slots over tables of 8 blocks, 3 heads, 2 layers: an idle lane;
    a window starting in the slot's first block and crossing into the
    second; draft length 0; a dead last row; a window ending at the
    table's last position (dead rows past the table); a window crossing a
    block in a slot reading another slot's first two blocks read-only.
    W = 1 is the decode step (positions 0, bs-2, bs+3, ...). int8 pools
    hold normal rows quantized on per-block grids 0.7-1.3x absmax/127.
    Returns (q, knew, vnew, kpool, vpool, scales or None, tables,
    positions, draft_lens, live rows)."""
    slots, L, maxb = 6, 2, 8
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


def long_window_case(g, W, bs, D, kind):
    """Seven slots over tables of 2048 keys, 3 heads, 2 layers, so that the
    split walk (bf16 and int8 pools) walks many ranges of RANGE_KEYS: an
    idle lane; a window across the first range boundary; a last key that
    opens a range of one key (one block); a window ending at the table's
    last position; a long context; a slot reading that one's first 512
    keys read-only; a decode-like step (draft length 0) ending a range.
    `kind`: "bfloat16" or "float32" pools, or "int8-bfloat16" /
    "int8-float32" (int8 pools, q in that dtype). Returns what
    `window_case` returns."""
    from paddle_tpu_torch.ops.paged_verify import RANGE_KEYS

    K = W - 1
    slots, heads, L, maxb = 7, 3, 2, 2048 // bs
    half = (K + 1) // 2
    pos = [0, RANGE_KEYS - half, 2 * RANGE_KEYS - min(2, K),
           maxb * bs - 1 - K, 1000, 700, RANGE_KEYS - 1]
    dlen = [0, K, min(2, K), K, min(5, K), min(3, K), 0]
    int8 = kind.startswith("int8")
    dtype = torch.float32 if kind.endswith("float32") else torch.bfloat16
    tables = torch.zeros((slots, maxb), dtype=torch.int32)
    nxt = 1
    for s in range(1, slots):
        nb = (pos[s] + dlen[s]) // bs + 1
        start = 0
        if s == 5:                       # slot 4's first 512 keys
            start = 512 // bs
            tables[s, :start] = tables[4, :start]
        tables[s, start:nb] = torch.arange(nxt, nxt + nb - start)
        nxt += nb - start
    shape = (L, nxt, bs, heads, D)
    kp, vp = (torch.randn(shape, generator=g, device="cuda")
              for _ in range(2))
    scales = None
    if int8:
        amax = torch.stack([kp.abs().amax((2, 3, 4)),
                            vp.abs().amax((2, 3, 4))], -1)
        scales = amax / 127 * (0.7 + 0.6 * torch.rand(
            amax.shape, generator=g, device="cuda"))
        kp, vp = (tpa._quant_rows(x, scales[..., i, None, None, None])
                  for i, x in enumerate((kp, vp)))
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    q, kn, vn = (torch.randn((slots, W, heads, D), generator=g,
                             device="cuda").to(dtype) for _ in range(3))
    dl = torch.tensor(dlen, dtype=torch.int32)
    live = torch.arange(W)[None, :] <= dl[:, None]
    live[0] = False
    return (q, kn, vn, kp, vp, scales, tables.cuda(),
            torch.tensor(pos, dtype=torch.int32, device="cuda"), dl.cuda(),
            live.cuda())


@pytest.mark.parametrize("kind", ["bfloat16", "float32", "int8-bfloat16",
                                  "int8-float32"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
@pytest.mark.parametrize("W", [5, 9])
def test_paged_verify_kernels_at_long_contexts(card, kind, D, bs, W):
    """Contexts up to 2047 keys at every block size: the split walk across
    up to 16 ranges, windows across a range boundary, a range of one key,
    the combine; f32 pools through the first design at the same case."""
    c = long_window_case(card, W, bs, D, kind)
    int8 = kind.startswith("int8")
    kernel, plain = ((paged_verify_attention_int8, paged_verify_int8_plain)
                     if int8 else
                     (paged_verify_attention, paged_verify_plain))
    err, pools, scales = _paged_kernel_vs_plain(kernel, plain, c, int8)
    assert err <= TOL[c[0].dtype] and pools and scales


def test_paged_verify_split_walk_gives_the_same_bits_twice(card):
    """The ranges are combined in a fixed order, without atomics: two runs
    on the same inputs give the same output bits."""
    q, kn, vn, kp, vp, _, tb, pos, dl, _ = long_window_case(
        card, 5, 16, 128, "bfloat16")
    outs = [paged_verify_attention(q, kn, vn, kp.clone(), vp.clone(), 1, tb,
                                   pos, dl) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


def test_paged_verify_split_walk_refuses_a_misaligned_view(card):
    """The split walk copies 16 bytes at a time: a bf16 pool whose base is
    not 16-byte aligned raises before a launch."""
    q, kn, vn, kp, vp, _, tb, pos, dl, _ = long_window_case(
        card, 5, 16, 64, "bfloat16")
    flat = torch.empty(kp.numel() + 1, dtype=kp.dtype, device="cuda")
    shifted = flat[1:].view(kp.shape)
    shifted.copy_(kp)
    launches = paged_verify_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_verify_attention(q, kn, vn, shifted, vp, 1, tb, pos, dl)
    assert paged_verify_attention.launches == launches


@pytest.mark.parametrize("kind", ["bfloat16", "float32", "int8-bfloat16",
                                  "int8-float32"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_paged_decode_kernels_at_long_contexts(card, kind, D, bs):
    """The decode step (W = 1) at contexts up to 2047 keys at every block
    size: positions 128 and 256 open a range of one key (the new one), 127
    ends the first range, 2047 is the table's last key, a slot reads
    another's first 512 keys read-only; the split walk (bf16 and int8
    pools) across up to 16 ranges and the combine, f32 pools through the
    first design. fp pools bit-identical whole, block 0 included (one idle
    lane writes it)."""
    c = long_window_case(card, 1, bs, D, kind)
    if kind.startswith("int8"):
        err, pools, scales = _paged_kernel_vs_plain(
            paged_decode_attention_int8, paged_decode_int8_plain, c, True)
        assert err <= TOL[c[0].dtype] and pools and scales
        return
    q, kn, vn, kp, vp, _, tb, pos, _, live = c
    k0, v0, k1, v1 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    ref = paged_decode_plain(q, kn, vn, k0, v0, 1, tb, pos)
    launches = paged_decode_attention.launches
    out = paged_decode_attention(q, kn, vn, k1, v1, 1, tb, pos)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == launches + 1
    assert (out.float() - ref.float())[live].abs().max().item() <= TOL[q.dtype]
    assert torch.equal(k0, k1) and torch.equal(v0, v1)


def test_paged_decode_split_walk_gives_the_same_bits_twice(card):
    """The ranges are combined in a fixed order, without atomics: two runs
    on the same inputs give the same output bits."""
    q, kn, vn, kp, vp, _, tb, pos, _, _ = long_window_case(
        card, 1, 16, 128, "bfloat16")
    outs = [paged_decode_attention(q, kn, vn, kp.clone(), vp.clone(), 1, tb,
                                   pos) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


def test_paged_decode_split_walk_refuses_a_misaligned_view(card):
    """The split walk copies 16 bytes at a time: a bf16 pool whose base is
    not 16-byte aligned raises before a launch."""
    q, kn, vn, kp, vp, _, tb, pos, _, _ = long_window_case(
        card, 1, 16, 64, "bfloat16")
    flat = torch.empty(kp.numel() + 1, dtype=kp.dtype, device="cuda")
    shifted = flat[1:].view(kp.shape)
    shifted.copy_(kp)
    launches = paged_decode_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_decode_attention(q, kn, vn, shifted, vp, 1, tb, pos)
    assert paged_decode_attention.launches == launches


# the paged kernels of a tensor-parallel shard: (wrapper, plain version,
# window rows, int8)
SHARD_PAGED = {"decode": (paged_decode_attention, paged_decode_plain, 1,
                          False),
               "verify": (paged_verify_attention, paged_verify_plain, 5,
                          False),
               "decode_int8": (paged_decode_attention_int8,
                               paged_decode_int8_plain, 1, True),
               "verify_int8": (paged_verify_attention_int8,
                               paged_verify_int8_plain, 5, True)}


@pytest.mark.parametrize("kind", list(SHARD_PAGED))
@pytest.mark.parametrize("heads", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_at_a_shards_heads(card, kind, heads, dtype):
    """GPT-1.3B's 16 heads over mp 2 and 4: each paged kernel at 8 and 4
    heads a shard, D 128, block 16, against its plain version."""
    kernel, plain, W, int8 = SHARD_PAGED[kind]
    c = window_case(card, W, 16, 128, dtype, int8, heads=heads)
    err, pools, scales = _paged_kernel_vs_plain(kernel, plain, c, int8)
    assert err <= TOL[dtype] and pools and scales


def _heads(t, r, mp, dim):
    n = t.shape[dim] // mp
    return t.narrow(dim, r * n, n).contiguous()


@pytest.mark.parametrize("kind", list(SHARD_PAGED))
@pytest.mark.parametrize("mp", [2, 4])
def test_sharded_paged_steps_are_the_whole_steps_heads(card, kind, mp):
    """The tensor-parallel step editions on a virtual mesh of the card
    (every shard on it): each shard's output and pools are the 16-head
    step's heads, bit for bit, and under int8 the shared scales are the
    16-head step's (the folded absmax), bf16, D 128, block 16."""
    _, _, W, int8 = SHARD_PAGED[kind]
    q, kn, vn, kp, vp, sc, tb, pos, dl, live = window_case(
        card, W, 16, 128, torch.bfloat16, int8, heads=16)
    shard_sc = None if sc is None else sc.clone()
    kps = [_heads(kp, r, mp, 3) for r in range(mp)]
    vps = [_heads(vp, r, mp, 3) for r in range(mp)]
    qs, ks, vs = ([_heads(t, r, mp, 2) for r in range(mp)]
                  for t in (q, kn, vn))
    rep = [tb] * mp, [pos] * mp
    if W == 1:
        whole = tpa.paged_attention_step(q, kn, vn, kp, vp, 1, tb, pos,
                                         scales=sc)
        outs = tpa.paged_attention_step_shards(
            qs, ks, vs, kps, vps, 1, *rep,
            scales=None if sc is None else [shard_sc] * mp)
    else:
        whole = tpa.paged_verify_window(q, kn, vn, kp, vp, 1, tb, pos, dl,
                                        scales=sc)
        outs = tpa.paged_verify_window_shards(
            qs, ks, vs, kps, vps, 1, *rep, [dl] * mp,
            scales=None if sc is None else [shard_sc] * mp)
    torch.cuda.synchronize()
    for r in range(mp):
        got, want = outs[r], _heads(whole, r, mp, 2)
        assert torch.equal(got[live], want[live])
        assert torch.equal(kps[r][:, 1:], _heads(kp, r, mp, 3)[:, 1:])
        assert torch.equal(vps[r][:, 1:], _heads(vp, r, mp, 3)[:, 1:])
    assert sc is None or torch.equal(shard_sc, sc)


# the causal kernels' lengths: the tile edges of the bf16 design (16-row
# warp blocks, 64-key and 64-row tiles, 128-row forward q tiles) and of the
# f32 design (64), a length of one, ragged lengths, and a long one
CAUSAL_S = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 300, 512, 1000]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", CAUSAL_S)
@pytest.mark.parametrize("BH", [1, 4])
def test_causal_kernel_matches_plain(card, dtype, D, S, BH):
    """O and the LSE of the kernel against the plain version, the same
    bits on a rerun; BH 1 leaves most of the card's SMs idle."""
    q, k, v = (torch.randn((BH, S, D), generator=card,
                           device="cuda").to(dtype) for _ in range(3))
    scale = 1.0 / math.sqrt(D)
    o_ref, l_ref = causal_attention_plain(q, k, v, scale)
    o, lse = causal_attention_fwd(q, k, v, scale)
    o2, lse2 = causal_attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert (o.float() - o_ref.float()).abs().max().item() <= TOL[dtype]
    lse_tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    assert (lse - l_ref).abs().max().item() <= lse_tol
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", CAUSAL_S)
@pytest.mark.parametrize("BH", [1, 4])
def test_causal_bwd_kernel_matches_plain(card, dtype, D, S, BH):
    """dq, dk, dv of the kernel against the plain version from the same
    forward O and LSE, one launch counted, the same bits on a rerun."""
    q, k, v, do = (torch.randn((BH, S, D), generator=card,
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
@pytest.mark.parametrize("S", [128, 256, 384, 512])
@pytest.mark.parametrize("mask", [None, "B", "BH"])
def test_shortseq_kernel_matches_plain(card, dtype, D, S, mask):
    """O and LSE of the forward kernel (mask-free, a [B, S] mask broadcast
    over heads, a [BH, S] mask; padded tails and one all-padding sequence)
    against the plain version; the variant's own count moves; a rerun gives
    the same bits."""
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
    o2, lse2 = shortseq_attention_fwd(q, k, v, scale, km)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [128, 512])
@pytest.mark.parametrize("mask", [None, "B"])
def test_shortseq_kernel_with_peaked_logits(card, D, S, mask):
    """bf16, q scaled by 8: logits of ~8 times the usual spread, so each
    row's softmax is dominated by a few keys and p = exp(s - m) is far from
    1 elsewhere; a row max taken over part of the keys, or different in the
    two passes, moves O and the LSE far past the bars. O per sequence
    within SHORTSEQ_FWD_TOL, the LSE as the bf16 case above, the same bits
    on a rerun."""
    B, H = 3, 2
    q, k, v = (torch.randn((B * H, S, D), generator=card, device="cuda")
               for _ in range(3))
    q, k, v = (8 * q).bfloat16(), k.bfloat16(), v.bfloat16()
    km = shortseq_key_mask(B, H, S, mask)
    scale = 1.0 / math.sqrt(D)
    o_ref, l_ref = shortseq_attention_plain(q, k, v, scale, km)
    o, lse = shortseq_attention_fwd(q, k, v, scale, km)
    o2, lse2 = shortseq_attention_fwd(q, k, v, scale, km)
    torch.cuda.synchronize()
    rel, floor = SHORTSEQ_FWD_TOL[torch.bfloat16]
    err = (o.float() - o_ref.float()).abs().amax((1, 2))
    assert bool((err <= rel * o_ref.float().abs().amax((1, 2))
                 + floor).all())
    assert (lse - l_ref).abs().max().item() <= 1e-3
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


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
    (64, 300, False), (257, 128, False), (1, 77, False),
    (1000, 1000, True), (300, 700, False)])
def test_sdpa_forward_kernel_matches_plain(card, dtype, D, Sq, Skv, causal):
    """B6 against its plain version, one launch a call, no plain call, the
    same bits on a rerun (no atomics); the last two shapes walk many q and
    key tiles (at D 192 and 256 the bf16 design reads Q's fragments again
    from shared memory at every key tile)."""
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


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("Sq,Skv,causal", [(200, 1000, False),
                                           (1000, 1000, True)])
def test_sdpa_forward_kernel_with_peaked_logits(card, D, Sq, Skv, causal):
    """bf16, q scaled by 8 and a key length not a multiple of the 64-key
    tile: the running max moves by many units from tile to tile, so a wrong
    rescale of l or of the accumulator shows, and the zero-filled keys
    past Skv would score 0 (a large weight against peaked logits) if left
    unmasked. Within SDPA_TOL, the same bits on a rerun."""
    q = torch.randn((3, Sq, D), generator=card, device="cuda")
    k, v = (torch.randn((3, Skv, D), generator=card, device="cuda")
            for _ in range(2))
    q, k, v = (8 * q).bfloat16(), k.bfloat16(), v.bfloat16()
    scale = 1.0 / math.sqrt(D)
    ref = sdpa_forward_plain(q, k, v, scale, causal)
    o = sdpa_forward(q, k, v, scale, causal)
    again = sdpa_forward(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert torch.equal(o, again)
    assert sdpa_within_tol(o, ref, torch.bfloat16)


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


SDPA_BWD_SHAPES = [(1, 1, True), (63, 63, True), (130, 130, True),
                   (512, 512, True), (64, 300, False), (257, 128, False),
                   (128, 384, False), (384, 128, False), (300, 700, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 192, 256, 320, 384, 448, 512])
@pytest.mark.parametrize("Sq,Skv,causal", SDPA_BWD_SHAPES)
def test_sdpa_lse_variant_matches_plain(card, dtype, D, Sq, Skv, causal):
    """B6's LSE variant: the LSE against the plain version's (fp32 from the
    same products: 1e-3 in bf16, where exp2f and the tile order enter, as
    the causal forward's LSE; 1e-5 in f32), and O the same bits as the
    inference instance's; head dims over 256 take the wide design, whose O
    is held to SDPA_TOL. One launch a call, each counted once more in
    `.lse_launches`."""
    q = torch.randn((2, Sq, D), generator=card, device="cuda").to(dtype)
    k, v = (torch.randn((2, Skv, D), generator=card, device="cuda").to(dtype)
            for _ in range(2))
    scale = 1.0 / math.sqrt(D)
    o_ref, l_ref = sdpa_forward_plain(q, k, v, scale, causal,
                                      return_lse=True)
    counts = sdpa_forward.launches, sdpa_forward.lse_launches
    o, lse = sdpa_forward(q, k, v, scale, causal, return_lse=True)
    o_inf = sdpa_forward(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert (sdpa_forward.launches - counts[0],
            sdpa_forward.lse_launches - counts[1]) == (2, 1)
    assert lse.shape == (2, Sq) and lse.dtype == torch.float32
    lse_tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    assert (lse - l_ref).abs().max().item() <= lse_tol
    assert torch.equal(o, o_inf)
    assert sdpa_within_tol(o, o_ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 192, 256, 320, 384, 448, 512])
@pytest.mark.parametrize("Sq,Skv,causal", SDPA_BWD_SHAPES)
def test_sdpa_backward_kernel_matches_plain(card, dtype, D, Sq, Skv, causal):
    """The library route's backward against its plain version from the same
    forward O and LSE (B6's LSE variant): BWD_TOL, B2's and B13's bars;
    ragged Sq != Skv both ways, causal up to 512 rows at every head dim
    (the bf16 wgmma design up to 256, its two consumer warpgroups splitting
    dK/dV's columns at 192 and 256; the wide FMA design above and in f32);
    one launch a call, no plain call, the same bits on a rerun (no
    atomics)."""
    q, do = (torch.randn((2, Sq, D), generator=card, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((2, Skv, D), generator=card, device="cuda").to(dtype)
            for _ in range(2))
    scale = 1.0 / math.sqrt(D)
    o, lse = sdpa_forward(q, k, v, scale, causal, return_lse=True)
    ref = sdpa_backward_plain(q, k, v, o, do, lse, scale, causal)
    launches, plain = sdpa_backward.launches, sdpa_backward.plain_calls
    got = sdpa_backward(q, k, v, o, do, lse, scale, causal)
    again = sdpa_backward(q, k, v, o, do, lse, scale, causal)
    torch.cuda.synchronize()
    assert (sdpa_backward.launches - launches,
            sdpa_backward.plain_calls - plain) == (2, 0)
    assert [(x.dtype, x.shape) for x in got] == [
        (dtype, q.shape), (dtype, k.shape), (dtype, v.shape)]
    assert bwd_within_tol(got, ref, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# lengths off the wgmma design's tiles: 64-row q and key boxes, 128 keys a
# dK/dV CTA and 128 q rows a dQ CTA up to D 128
WGMMA_BWD_SHAPES = [(3, 129, 129, True), (1, 191, 191, True),
                    (3, 65, 193, False), (2, 200, 70, False),
                    (1, 1, 129, False), (1, 640, 640, True)]


@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("BH,Sq,Skv,causal", WGMMA_BWD_SHAPES)
def test_sdpa_backward_wgmma_off_its_tiles(card, D, BH, Sq, Skv, causal):
    """The bf16 wgmma design where TMA zero-fills a box's tail (Sq and Skv
    off the 64-row boxes and the 128-row CTAs, a head's tail beside the
    next head's rows at BH > 1) and causal walks start and end mid-CTA:
    BWD_TOL against the plain version, the same bits on a rerun."""
    dtype = torch.bfloat16
    q, do = (torch.randn((BH, Sq, D), generator=card,
                         device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((BH, Skv, D), generator=card,
                        device="cuda").to(dtype) for _ in range(2))
    scale = 1.0 / math.sqrt(D)
    o, lse = sdpa_forward(q, k, v, scale, causal, return_lse=True)
    ref = sdpa_backward_plain(q, k, v, o, do, lse, scale, causal)
    got = sdpa_backward(q, k, v, o, do, lse, scale, causal)
    again = sdpa_backward(q, k, v, o, do, lse, scale, causal)
    torch.cuda.synchronize()
    assert bwd_within_tol(got, ref, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_sdpa_backward_refuses_what_it_does_not_take(card):
    z = torch.zeros((2, 128, 64), device="cuda")
    lse = torch.zeros((2, 128), device="cuda")
    big = torch.zeros((2, 128, 576), device="cuda")
    with pytest.raises(ValueError, match="512"):
        sdpa_backward(big, big, big, big, big, lse)
    with pytest.raises(ValueError, match="lse"):
        sdpa_backward(z, z, z, z, z, lse[:, :64].contiguous())
    with pytest.raises(ValueError, match="Sq == Skv"):
        k = torch.zeros((2, 256, 64), device="cuda")
        sdpa_backward(z, k, k, z, z, lse, causal=True)
    with pytest.raises(ValueError, match="share"):
        sdpa_backward(z, z.bfloat16(), z, z, z, lse)


def test_transformer_trains_on_the_card_through_the_library_route(card):
    """A 1 + 1 layer Transformer (d_model 128, 2 heads: head dim 64) with
    residual dropout 0.1 and no attention or activation dropout, source
    640 and target 128 under the causal mask, through TrainStep with AdamW
    and mse_loss: each step launches B6 with its LSE and the library
    backward twice (the encoder's self-attention and the cross-attention),
    the one-pass update once, and no plain version; the decoder's masked
    self-attention is dense. The losses are finite."""
    from torch import nn

    from paddle_tpu_torch import AdamW, Transformer, TrainStep
    from paddle_tpu_torch.ops.nn_ops import mse_loss

    class Seq2Seq(nn.Module):
        def __init__(self, model, mask):
            super().__init__()
            self.model, self.mask = model, mask

        def forward(self, src, tgt):
            return self.model(src, tgt, tgt_mask=self.mask)

    model = Transformer(128, 2, 1, 1, 256, dropout=0.1, attn_dropout=0.0,
                        act_dropout=0.0, device="cuda", generator=card)
    net = Seq2Seq(model.train(),
                  Transformer.generate_square_subsequent_mask(128))
    step = TrainStep(net, AdamW(1e-3, parameters=net.parameters()), mse_loss)
    src, tgt, label = (torch.randn(shape, generator=card, device="cuda")
                       for shape in ((2, 640, 128), (2, 128, 128),
                                     (2, 128, 128)))
    wrappers = (sdpa_forward, sdpa_backward, optimizer_update)
    before = [(w.launches, w.plain_calls) for w in wrappers]
    lse = sdpa_forward.lse_launches
    dense = flash_attention.dense_calls
    losses = [float(step(src, tgt, label)) for _ in range(2)]
    assert [(w.launches - a, w.plain_calls - b)
            for w, (a, b) in zip(wrappers, before)] == [(4, 0), (4, 0),
                                                         (2, 0)]
    assert sdpa_forward.lse_launches - lse == 4
    assert flash_attention.dense_calls == dense
    assert all(math.isfinite(x) for x in losses)


OPT_SIZES = (1, 7, 4097, 2 ** 20 + 3, 5)


def _optimizer(kind, params):
    from paddle_tpu_torch import (SGD, Adadelta, Adagrad, Adam, AdamW, Lamb,
                                  Lars, Momentum, RMSProp)

    named = [(f"p{i}", p) for i, p in enumerate(params)]
    if kind.startswith("adamw"):   # parameter p1 does not decay
        return AdamW(1e-3, parameters=named, weight_decay=0.01,
                     apply_decay_param_fun=lambda n: n != "p1",
                     multi_precision=not kind.endswith("_bf16m"))
    if kind.startswith("adam"):
        return Adam(1e-3, parameters=named,
                    weight_decay=0.01 if "_l2" in kind else None,
                    multi_precision=not kind.endswith("_bf16m"))
    if kind.startswith("sgd"):
        return SGD(0.1, parameters=named,
                   weight_decay=0.01 if kind.endswith("_wd") else None)
    if kind == "adagrad":
        return Adagrad(0.1, parameters=named, weight_decay=0.01,
                       initial_accumulator_value=0.1)
    if kind.startswith("rmsprop"):
        centered = kind.endswith("_centered")
        return RMSProp(1e-3, rho=0.9, momentum=0.9 if centered else 0.0,
                       centered=centered, parameters=named,
                       weight_decay=0.01 if centered else None)
    if kind == "adadelta":
        return Adadelta(1.0, rho=0.9, parameters=named, weight_decay=0.01)
    if kind == "lars":    # parameter p1 does not decay
        return Lars(0.1, 0.9, lars_coeff=0.01, lars_weight_decay=0.05,
                    parameters=named, exclude_from_weight_decay=["p1"])
    if kind == "lamb":
        return Lamb(1e-3, lamb_weight_decay=0.01, parameters=named)
    return Momentum(0.1, 0.9, parameters=named,
                    use_nesterov=kind.startswith("nesterov"),
                    weight_decay=0.01 if kind.endswith("_wd") else None)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


ELEMENTWISE_KINDS = ["adamw", "adam", "adam_l2", "momentum", "momentum_wd",
                     "nesterov", "nesterov_wd", "sgd", "sgd_wd", "adagrad",
                     "rmsprop", "rmsprop_centered", "adadelta",
                     "adam_l2_bf16m", "adamw_bf16m"]


@pytest.mark.parametrize("kind", ELEMENTWISE_KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed"])
def test_optimizer_update_is_bitwise_the_loop(card, kind, dtype,
                                              monkeypatch):
    """The one-pass kernel against the per-parameter loop (its plain
    version, run on the same card): parameters and accumulators the same
    bits after each of three steps, at sizes 1, 7, 4097 and 2^20 + 3,
    with one parameter's grad None at the second step; one launch a step
    for each (device, dtype) group, no plain update. Every elementwise
    rule: AdamW, Adam (with and without L2), Momentum (Nesterov, L2), SGD,
    Adagrad, RMSProp (plain, and centered with momentum: three
    accumulators), Adadelta, and Adam and AdamW with moments in the
    parameter's dtype (`_bf16m`: bf16 moments for bf16 parameters)."""
    from paddle_tpu_torch.optimizer import optimizer as opt_mod

    dtypes = ([getattr(torch, dtype)] * len(OPT_SIZES) if dtype != "mixed"
              else [torch.float32, torch.bfloat16] * 3)[:len(OPT_SIZES)]
    got = [(torch.randn(n, generator=card, device="cuda") * 0.5).to(dt)
           for n, dt in zip(OPT_SIZES, dtypes)]
    want = [p.clone() for p in got]
    opt_k, opt_p = _optimizer(kind, got), _optimizer(kind, want)
    groups = len(set(dtypes))
    for step in range(3):
        grads = [None if (step == 1 and i == 2) else
                 torch.randn(p.shape, generator=card, device="cuda").to(p.dtype)
                 for i, p in enumerate(got)]
        for a, b, g in zip(got, want, grads):
            a.grad, b.grad = g, None if g is None else g.clone()
        counts = optimizer_update.launches, optimizer_update.plain_calls
        opt_k.step()
        assert (optimizer_update.launches - counts[0],
                optimizer_update.plain_calls - counts[1]) == (groups, 0)
        with monkeypatch.context() as m:
            m.setattr(opt_mod, "optimizer_update", optimizer_update_plain)
            opt_p.step()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b)), (kind, step)
        for name, lst in opt_k._accumulators.items():
            for a, b in zip(lst, opt_p._accumulators[name]):
                assert torch.equal(_bits(a), _bits(b)), (kind, name, step)
        opt_k.clear_grad()
        opt_p.clear_grad()


@pytest.mark.parametrize("kind", ["adamw", "nesterov_wd"])
def test_optimizer_update_takes_any_dense_layout(card, kind, monkeypatch):
    """Parameters in channels_last and transposed layouts: the kernel
    against the loop, bitwise, over three steps. The first step's grads
    are contiguous (copied into the parameters' layout); before the third,
    one parameter turns contiguous after its accumulators were made
    (they are laid out anew). A parameter that is not dense raises."""
    from paddle_tpu_torch.optimizer import optimizer as opt_mod

    def params():
        g = torch.Generator("cuda").manual_seed(5)
        w = torch.randn((16, 8, 3, 3), generator=g, device="cuda")
        t = torch.randn((64, 33), generator=g, device="cuda")
        return [w.to(torch.bfloat16, memory_format=torch.channels_last),
                t.to(torch.bfloat16).t(),
                torch.randn(7, generator=g, device="cuda").to(torch.bfloat16)]

    got, want = params(), params()
    opt_k, opt_p = _optimizer(kind, got), _optimizer(kind, want)
    for step in range(3):
        if step == 2:
            for ps in (got, want):
                ps[0].data = ps[0].data.contiguous()
        for a, b in zip(got, want):
            g = torch.randn(a.shape, generator=card,
                            device="cuda").to(a.dtype)
            if step:
                g = torch.empty_like(a).copy_(g)
            a.grad, b.grad = g, g.clone()
        launches = optimizer_update.launches
        opt_k.step()
        assert optimizer_update.launches == launches + 1
        with monkeypatch.context() as m:
            m.setattr(opt_mod, "optimizer_update", optimizer_update_plain)
            opt_p.step()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b)), (kind, step)
        for name, lst in opt_k._accumulators.items():
            for a, b, p in zip(lst, opt_p._accumulators[name], got):
                assert a.stride() == p.stride(), (kind, name, step)
                assert torch.equal(_bits(a), _bits(b)), (kind, name, step)
    gap = torch.zeros((8, 16), device="cuda")[:, ::2]
    gap.grad = torch.zeros_like(gap)
    with pytest.raises(ValueError, match="dense"):
        _optimizer(kind, [gap]).step()


def test_optimizer_update_refuses_what_it_does_not_take(card):
    from paddle_tpu_torch import AdamW

    p = torch.zeros(8, device="cuda")
    opt = AdamW(1e-3, parameters=[p])
    opt._ensure_state()
    for g in (torch.zeros(8, device="cuda", dtype=torch.bfloat16),
              torch.zeros(9, device="cuda")):
        with pytest.raises(ValueError, match="grad"):
            optimizer_update(opt, [(0, p, g)], 1e-3, 0)
    h = torch.zeros(8, device="cuda", dtype=torch.float16)
    h.grad = torch.zeros_like(h)
    with pytest.raises(ValueError, match="dtype"):
        AdamW(1e-3, parameters=[h]).step()


def test_optimizer_update_refuses_a_mixed_group_and_wrong_accumulators(card):
    """A group of two dtypes, an accumulator of another dtype than the rule
    keeps (an fp32 moment under multi_precision=False, a bf16 velocity)
    raise before any launch."""
    from paddle_tpu_torch import Adam, Momentum

    p = torch.zeros(8, device="cuda")
    q = torch.zeros(8, device="cuda", dtype=torch.bfloat16)
    opt = Momentum(0.1, parameters=[p, q])
    opt._ensure_state()
    launches = optimizer_update.launches
    with pytest.raises(ValueError, match="one device and one dtype"):
        optimizer_update(opt, [(0, p, torch.zeros_like(p)),
                               (1, q, torch.zeros_like(q))], 0.1, 0)
    opt._accumulators["velocity"][0] = torch.zeros(
        8, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="accumulator velocity"):
        optimizer_update(opt, [(0, p, torch.zeros_like(p))], 0.1, 0)
    low = Adam(1e-3, parameters=[q], multi_precision=False)
    low._ensure_state()
    low._accumulators["moment1"][0] = torch.zeros(8, device="cuda")
    with pytest.raises(ValueError, match="accumulator moment1"):
        optimizer_update(low, [(0, q, torch.zeros_like(q))], 1e-3, 0)
    assert optimizer_update.launches == launches


# Lars and Lamb against the loop: norms summed in another order than
# torch.sum's (per block, then per parameter, in a fixed order), so the
# parameters and accumulators are held to a tolerance, max |kernel - loop|
# <= NORM_RULE_TOL * (max |loop| + 1e-30) per tensor, and a rerun from the
# same state gives the same bits
NORM_RULE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.mark.parametrize("kind", ["lars", "lamb"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_rules_match_the_loop_and_repeat_bitwise(card, kind, dtype,
                                                      monkeypatch):
    """Three steps of Lars (p1 excluded from decay) and Lamb, the kernel
    (the norm pass, then the update: one update launch and one norm pass a
    step) against the loop on the card, within NORM_RULE_TOL; the norm pass
    against its plain version; and the same step twice from one state
    gives the same bits."""
    from paddle_tpu_torch.ops.optimizer_update import (optimizer_norms,
                                                       optimizer_norms_plain)
    from paddle_tpu_torch.optimizer import optimizer as opt_mod

    def fresh():
        g = torch.Generator("cuda").manual_seed(3)
        return [(torch.randn(n, generator=g, device="cuda") * 0.5).to(dtype)
                for n in OPT_SIZES]

    got, want, again = fresh(), fresh(), fresh()
    opts = [_optimizer(kind, ps) for ps in (got, want, again)]
    for step in range(3):
        grads = [torch.randn(p.shape, generator=card, device="cuda").to(dtype)
                 for p in got]
        for ps in (got, want, again):
            for p, g in zip(ps, grads):
                p.grad = g.clone()
        group = [(i, p, p.grad) for i, p in enumerate(got)]
        opts[0]._ensure_state()
        norms = optimizer_norms(opts[0], group, 0.1, step)
        plain = optimizer_norms_plain(opts[0], group, 0.1, step)
        torch.testing.assert_close(norms, plain, rtol=1e-5, atol=1e-30)
        counts = (optimizer_update.launches, optimizer_norms.launches)
        opts[0].step()
        assert (optimizer_update.launches - counts[0],
                optimizer_norms.launches - counts[1]) == (1, 1)
        opts[2].step()
        with monkeypatch.context() as m:
            m.setattr(opt_mod, "optimizer_update", optimizer_update_plain)
            opts[1].step()
        torch.cuda.synchronize()
        tol = NORM_RULE_TOL[dtype]
        pairs = list(zip(got, want)) + [
            (a, b) for name, lst in opts[0]._accumulators.items()
            for a, b in zip(lst, opts[1]._accumulators[name])]
        for a, b in pairs:
            err = (a.float() - b.float()).abs().max().item()
            assert err <= tol * (b.float().abs().max().item() + 1e-30), \
                (kind, step, err)
        for a, b in zip(got, again):
            assert torch.equal(_bits(a), _bits(b)), (kind, step)
        for name, lst in opts[0]._accumulators.items():
            for a, b in zip(lst, opts[2]._accumulators[name]):
                assert torch.equal(_bits(a), _bits(b)), (kind, name, step)
        for o in opts:
            o.clear_grad()


MERGE_SIZES = (1, 7, 2048, 4097, 2 ** 20 + 3)


def _merge_case(card, dtype, bad=False):
    """Grads of MERGE_SIZES in `dtype` (one inf and one nan in the last
    when `bad`) and fp32 buffers, on the card."""
    grads = [(torch.randn(n, generator=card, device="cuda") * 3).to(dtype)
             for n in MERGE_SIZES]
    if bad:
        grads[-1][5] = float("inf")
        grads[-1][9] = float("nan")
    grads[0][0] = -0.0
    bufs = [torch.randn(n, generator=card, device="cuda")
            for n in MERGE_SIZES]
    return grads, bufs


def _same(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("bad", [False, True])
def test_grad_merge_is_bitwise_its_plain_version(card, dtype, first, bad):
    """K1: one launch over the group, buffers the plain version's bits
    (at a window's first micro-step `0 + g`, -0 turned to +0 as the add to
    a zero buffer turns it), both flags raised exactly when a grad is not
    finite; without flags, nothing else written."""
    from paddle_tpu_torch.ops.grad_merge import grad_merge, grad_merge_plain

    grads, bufs = _merge_case(card, dtype, bad)
    ref = [b.clone() for b in bufs]
    flags = [torch.zeros(1, dtype=torch.int32, device="cuda")
             for _ in range(4)]
    launches = grad_merge.launches
    grad_merge(grads, bufs, first, flags[:2])
    grad_merge_plain(grads, ref, first, flags[2:])
    assert grad_merge.launches == launches + 1
    torch.cuda.synchronize()
    assert _same(bufs, ref)
    assert [int(f) for f in flags] == [int(bad)] * 4
    if first:
        assert _bits(bufs[0])[0].item() == 0          # +0, not -0
    grad_merge(grads, bufs, False)
    grad_merge_plain(grads, ref, False)
    assert _same(bufs, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [None, 65536.0, 3.0e38])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_grad_finish_is_bitwise_its_plain_version(card, dtype, scale, k):
    """K2's finish: `b / scale` (a divide: at 3e38 the fp32 reciprocal is
    subnormal) then times fp32(1/K), rounded into the grads, the plain
    version's bits."""
    from paddle_tpu_torch.ops.grad_merge import (grad_finish,
                                                 grad_finish_plain)

    grads, bufs = _merge_case(card, dtype)
    bufs = [b * 1e30 if scale and scale > 1e30 else b for b in bufs]
    ref = [torch.empty_like(g) for g in grads]
    launches = grad_finish.launches
    grad_finish(grads, bufs, scale, k)
    grad_finish_plain(ref, bufs, scale, k)
    assert grad_finish.launches == launches + 1
    torch.cuda.synchronize()
    assert _same(grads, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bad", [False, True])
def test_grad_unscale_is_bitwise_its_plain_version(card, dtype, bad):
    """K2's unscale: the flag over the scaled grads, then each grad
    divided by the scale in place, the plain version's bits."""
    from paddle_tpu_torch.ops.grad_merge import (grad_unscale,
                                                 grad_unscale_plain)

    grads, _ = _merge_case(card, dtype, bad)
    ref = [g.clone() for g in grads]
    flags = [torch.zeros(1, dtype=torch.int32, device="cuda")
             for _ in range(2)]
    launches = grad_unscale.launches
    grad_unscale(grads, 3.0e38, flags[0])
    grad_unscale_plain(ref, 3.0e38, flags[1])
    assert grad_unscale.launches == launches + 1
    torch.cuda.synchronize()
    assert _same(grads, ref)
    assert [int(f) for f in flags] == [int(bad)] * 2


def test_grad_merge_refuses_what_it_does_not_take(card):
    """A grad that is not dense, a group of two dtypes, a buffer that is
    not fp32 (or not in its grad's layout) raise before any launch."""
    from paddle_tpu_torch.ops.grad_merge import (grad_finish, grad_merge,
                                                 grad_unscale)

    g = torch.zeros(8, device="cuda")
    b = torch.zeros(8, device="cuda")
    gap = torch.zeros((8, 16), device="cuda")[:, ::2]
    counts = [w.launches for w in (grad_merge, grad_finish, grad_unscale)]
    with pytest.raises(ValueError, match="dense"):
        grad_unscale([gap], 2.0, torch.zeros(1, dtype=torch.int32,
                                             device="cuda"))
    with pytest.raises(ValueError, match="one device and one dtype"):
        grad_merge([g, g.to(torch.bfloat16)], [b, b.clone()], True)
    with pytest.raises(ValueError, match="float32"):
        grad_merge([g], [b.to(torch.bfloat16)], False)
    with pytest.raises(ValueError, match="layout"):
        grad_finish([torch.zeros(4, 6, device="cuda")],
                    [torch.zeros(6, 4, device="cuda").t()], None, 2)
    with pytest.raises(ValueError, match="no kernel"):
        grad_merge([g.half()], [b], True)
    assert counts == [w.launches for w in (grad_merge, grad_finish,
                                           grad_unscale)]


def test_trainstep_merge_and_scaler_launch_the_kernels(card):
    """A small bf16 MLP with an unreached Linear: TrainStep with
    accumulate_steps=3 and a GradScaler launches the merge once a
    micro-step, the finish and the update once a window (the zero grads in
    the group), no plain version; at a scale that overflows the window is
    skipped: no finish, no update, parameters and accumulators bitwise
    kept, the scale halved. Without merge, the unscale launches once a
    step. A BatchNorm model's running statistics survive a skipped step."""
    from paddle_tpu_torch import AdamW, TrainStep
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.nn.norm import BatchNorm2D
    from paddle_tpu_torch.ops.grad_merge import (grad_finish, grad_merge,
                                                 grad_unscale)
    from paddle_tpu_torch.ops.nn_ops import mse_loss

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(64, 64)
            self.off = torch.nn.Linear(64, 64)
            self.bn = BatchNorm2D(4, device="cpu")

        def forward(self, x):
            return self.bn(self.fc(x).reshape(-1, 4, 4, 4)).reshape(-1, 64)

    torch.manual_seed(0)
    net = Net().to("cuda", torch.bfloat16)
    # a decay of 1 % a step, so that the unreached weight moves in bf16
    opt = AdamW(1e-2, parameters=net.parameters(), weight_decay=1.0)
    scaler = GradScaler(init_loss_scaling=2.0 ** 10,
                        decr_every_n_nan_or_inf=1)
    step = TrainStep(net, opt, mse_loss, accumulate_steps=3, scaler=scaler)
    x = torch.randn(8, 64, generator=card, device="cuda").to(torch.bfloat16)
    y = torch.randn(8, 64, generator=card, device="cuda").to(torch.bfloat16)
    wrappers = (grad_merge, grad_finish, grad_unscale, optimizer_update)
    before = [(w.launches, w.plain_calls) for w in wrappers]
    off = net.off.weight.detach().clone()
    losses = [float(step(x, y)) for _ in range(6)]
    assert all(math.isfinite(v) for v in losses)
    assert [(w.launches - a, w.plain_calls - b)
            for w, (a, b) in zip(wrappers, before)] == [(6, 0), (2, 0),
                                                        (0, 0), (2, 0)]
    assert opt._step_count == 2 and scaler.get_scale() == 2.0 ** 10
    assert not torch.equal(net.off.weight, off)      # decayed
    kept = [t.clone() for t in list(net.parameters()) + list(net.buffers())
            + [a for lst in opt._accumulators.values() for a in lst]]
    scaler._scale = 3.0e38
    counts = [w.launches for w in wrappers]
    for _ in range(3):
        step(x, y * 1e4)
    assert [w.launches - c for w, c in zip(wrappers, counts)] == [3, 0, 0, 0]
    now = (list(net.parameters()) + list(net.buffers())
           + [a for lst in opt._accumulators.values() for a in lst])
    assert len(now) == len(kept)
    # the window skipped: parameters and accumulators kept; the buffers
    # too, each micro-step having overflowed
    assert _same(now, kept)
    assert opt._step_count == 2 and scaler.get_scale() == 1.5e38
    one = TrainStep(net, opt, mse_loss,
                    scaler=GradScaler(init_loss_scaling=2.0 ** 10))
    counts = [w.launches for w in wrappers]
    one(x, y)
    assert [w.launches - c for w, c in zip(wrappers, counts)] == [0, 0, 1, 1]


def test_sdpa_forward_refuses_what_it_does_not_take(card):
    z = torch.zeros((2, 128, 64), device="cuda")
    for q, k, match in (
            (torch.zeros((2, 128, 576), device="cuda"),) * 2 + ("512",),
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
    library shapes launch B6 when no gradient is needed, and B6 with its
    LSE then the library backward when one is (gradients as the CPU's
    plain versions give them); head dim 320 runs the same way; head dim
    576 raises naming the kernels' limit of 512; shapes no kernel takes
    are dense."""
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
    for shape in ((1, 1024, 2, 64), (1, 128, 1, 320)):
        zg = torch.randn(shape, generator=card,
                         device="cuda").requires_grad_()
        do = torch.randn(shape, generator=card, device="cuda")
        counts = (sdpa_forward.lse_launches, sdpa_backward.launches,
                  sdpa_backward.plain_calls)
        grads = torch.autograd.grad(flash_attention(zg, zg, zg,
                                                    causal=False),
                                    zg, do)[0]
        assert (sdpa_forward.lse_launches - counts[0],
                sdpa_backward.launches - counts[1],
                sdpa_backward.plain_calls - counts[2]) == (1, 1, 0)
        zc = zg.detach().cpu().requires_grad_()
        want = torch.autograd.grad(flash_attention(zc, zc, zc, causal=False),
                                   zc, do.cpu())[0]
        assert (grads.cpu() - want).abs().max().item() <= 1e-4
    with torch.no_grad():
        flash_attention(zg, zg, zg, causal=False)
    assert sdpa_forward.launches == launches + 4
    z576 = torch.zeros((1, 128, 1, 576), device="cuda")
    with pytest.raises(ValueError, match="512"):
        flash_attention(z576, z576, z576, causal=False)
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


def test_causal_kernels_refuse_a_misaligned_view(card):
    """A contiguous bf16 view whose storage starts 2 bytes past a 16-byte
    boundary: the kernels copy 16 bytes a lane, so both raise before a
    launch instead of faulting."""
    n = 2 * 8 * 64
    flat = torch.zeros(n + 8, dtype=torch.bfloat16, device="cuda")
    x = flat[1:1 + n].view(2, 8, 64)
    z = flat[8:8 + n].view(2, 8, 64)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    assert z.data_ptr() % 16 == 0
    lse = torch.zeros((2, 8), device="cuda")
    fwd, bwd = causal_attention_fwd.launches, causal_attention_bwd.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        causal_attention_fwd(x, z, z)
    with pytest.raises(ValueError, match="16-byte aligned"):
        causal_attention_bwd(z, z, z, z, x, lse)
    assert causal_attention_fwd.launches == fwd
    assert causal_attention_bwd.launches == bwd


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


# every distinct 1x1 of ResNet-50 (v1.5, the stride on the 3x3): (input
# side, Cin, Cout, stride, relu): conv1 of each block, conv3 (no ReLU) and
# the downsample projections (no ReLU, stride 2 from layer2 on)
RESNET50_1X1 = [(56, 64, 64, 1, True), (56, 64, 256, 1, False),
                (56, 256, 64, 1, True), (56, 256, 128, 1, True),
                (56, 256, 512, 2, False), (28, 128, 512, 1, False),
                (28, 512, 128, 1, True), (28, 512, 256, 1, True),
                (28, 512, 1024, 2, False), (14, 256, 1024, 1, False),
                (14, 1024, 256, 1, True), (14, 1024, 512, 1, True),
                (14, 1024, 2048, 2, False), (7, 512, 2048, 1, False),
                (7, 2048, 512, 1, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RESNET50_1X1,
                         ids=[f"{h}-{ci}-{co}-s{s}"
                              for h, ci, co, s, _ in RESNET50_1X1])
def test_conv1x1_kernel_at_resnet50_shapes(card, dtype, shape):
    """B7 (bf16 on the tensor cores, f32 in fp32 FMA) at every 1x1 of
    ResNet-50 at batch 2, the stride-2 projections read in place."""
    H, cin, cout, s, relu = shape
    x, w, scale, shift = conv_case(card, 2, H, H, cin, cout, 1, dtype)
    before = conv1x1_bn_relu.launches
    got = conv1x1_bn_relu(x, w, scale, shift, s, 0, relu)
    ref = conv_bn_relu_plain(x, w, scale, shift, s, 0, relu)
    torch.cuda.synchronize()
    assert conv1x1_bn_relu.launches == before + 1
    assert got.shape == ref.shape and got.is_contiguous()
    assert conv_rel_err(got, ref) <= CONV_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", [(3, 7, 9, 72, 72), (1, 5, 5, 72, 136),
                                   (2, 13, 11, 136, 72),
                                   (1, 3, 3, 200, 24)],
                         ids=["M189-72-72", "M25-72-136", "M286-136-72",
                              "M9-200-24"])
def test_conv1x1_kernel_at_ragged_tiles(card, dtype, stride, shape):
    """B7 with M not a multiple of the 128-pixel tile, Cin not a multiple
    of the 64-channel chunk (72: a chunk of 8 channels; 200: four chunks,
    the ring wrapping) and Cout not a multiple of the 64-channel tile."""
    N, H, W, cin, cout = shape
    x, w, scale, shift = conv_case(card, N, H, W, cin, cout, 1, dtype)
    got = conv1x1_bn_relu(x, w, scale, shift, stride, 0, False)
    ref = conv_bn_relu_plain(x, w, scale, shift, stride, 0, False)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert conv_rel_err(got, ref) <= CONV_TOL[dtype]
    assert bool((got < 0).any())


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
    192) launches B6 without a gradient, and B6 with its LSE then the
    library backward with one; a tiny GPT (head dim 16) takes a train step
    on the card with a finite loss."""
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
    bwd = sdpa_backward.launches
    flash_attention(zg, zg, zg, causal=True).sum().backward()
    assert sdpa_backward.launches == bwd + 1
    assert zg.grad.shape == z.shape and bool(torch.isfinite(zg.grad).all())
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["int", "SAME"])
@pytest.mark.parametrize("shape", [(2, 56, 56, 64, 72), (3, 25, 50, 64, 72)],
                         ids=["N2-56x56-64-72", "N3-25x50-64-72"])
def test_conv3x3_train_kernel_at_short_tiles(card, dtype, stride, padding,
                                             shape):
    """B9b where the bf16 kernel's tile (B8's) holds fewer than 128 pixels,
    so it writes more partial rows than ceil(M / 128): 56 x 56 (112-pixel
    tiles at stride 1, Cout 72 a ragged co tile) and 25 x 50 (100-pixel
    tiles over 75 output rows: a ragged last row group); the conv within
    CONV_TOL and the sums as `test_conv_train_kernels_match_plain`."""
    N, H, W, cin, cout = shape
    x, w, _, _ = conv_case(card, N, H, W, cin, cout, 3, dtype)
    pad = "SAME" if padding == "SAME" else 1
    before = conv3x3_train.launches
    got, sums = conv3x3_train(x, w, stride, pad)
    ref, ref_sums = conv_train_plain(x, w, stride, pad)
    torch.cuda.synchronize()
    assert conv3x3_train.launches == before + 1
    assert got.shape == ref.shape and got.dtype == dtype
    assert conv_rel_err(got, ref) <= CONV_TOL[dtype]
    p = ref.reshape(-1, cout).float()
    mag = torch.stack([p.abs().sum(0), (p * p).sum(0)])
    tol = SUM_TOL if dtype == torch.float32 else 2.0 ** -7
    assert sums_rel_err(sums, ref_sums, mag) <= tol


@pytest.mark.parametrize("k,dtype", [(3, torch.bfloat16), (1, torch.bfloat16),
                                     (3, torch.float32)])
def test_conv_train_refuses_a_short_partial_buffer(card, k, dtype):
    """`conv_train` launches with the rows `conv_train_partial_rows` gives
    (B8's 112-pixel tiles for the bf16 3x3 at 56 x 56: 56 rows, not 49)
    and refuses one row fewer instead of writing past the buffer."""
    N, H, cin, cout = 2, 56, 64, 72
    x, w, _, _ = conv_case(card, N, H, H, cin, cout, k, dtype)
    rows = conv_train_partial_rows(k, dtype, N, H, H, 1)
    assert rows == (56 if (k, dtype) == (3, torch.bfloat16) else 49)
    out = torch.empty((N, H, H, cout), dtype=dtype, device="cuda")
    sums = torch.empty((2, cout), device="cuda")
    partial = torch.empty((rows, 2, cout), device="cuda")
    fn = _bind("conv_bn_relu", "conv_train", 5, 13)

    def launch(r):
        return fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                  partial.data_ptr(), sums.data_ptr(), r, k,
                  1 if dtype == torch.bfloat16 else 0, N, H, H, cin, cout,
                  H, H, 1, k // 2, k // 2,
                  torch.cuda.current_stream().cuda_stream)

    assert launch(rows - 1) != 0
    assert launch(rows) == 0
    torch.cuda.synchronize()
    ref, ref_sums = conv_train_plain(x, w, 1, k // 2)
    assert conv_rel_err(out, ref) <= CONV_TOL[dtype]
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
@pytest.mark.parametrize("shape,stride", [
    ((2, 7, 7, 512, 2048), 1), ((5, 19, 13, 64, 72), 1),
    ((3, 37, 27, 64, 72), 2)], ids=["Cout2048", "M1235-splits3",
                                    "M798-splits2-s2"])
def test_conv1x1_bwd_kernel_at_long_reductions_and_splits(card, dtype, shape,
                                                          stride):
    """B10 at Cout 2048 (dX sums 128 k-steps: the two-level sum) and with
    the pixels cut into more than one split, M not a multiple of 8: dx
    within CONV_TOL, dw within SUM_TOL of max |dw| of the plain version and
    of an fp64 reference from the same bf16 dConv."""
    from paddle_tpu_torch.ops.conv import _splits

    N, H, W, cin, cout = shape
    x, w, _, _ = conv_case(card, N, H, W, cin, cout, 1, dtype)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    M = N * Ho * Wo
    assert cout == 2048 or (M % 8 and _splits(M, cin, cout)[0] > 1)
    y = torch.randn((N, Ho, Wo, cout), generator=card, device="cuda") \
        .to(dtype)
    dy = torch.randn((N, Ho, Wo, cout), generator=card, device="cuda") \
        .to(dtype)
    rows = bwd_bundle(card, cout, dtype)
    wt = w[0, 0].t().contiguous()
    dx, dw = conv1x1_bwd(x, dy, y, rows, wt, stride)
    rdx, rdw = conv1x1_bwd_plain(x, dy, y, rows, wt, stride)
    torch.cuda.synchronize()
    assert conv_rel_err(dx, rdx) <= CONV_TOL[dtype]
    assert conv_rel_err(dw, rdw) <= SUM_TOL
    r = rows.float()
    yv = y.reshape(-1, cout).float()
    dz = torch.where((yv - r[0]) * r[1] * r[2] + r[3] > 0,
                     dy.reshape(-1, cout).float(), 0.0)
    dcv = ((r[2] * r[5]) * (dz - r[6] - (yv - r[4]) * r[5] * r[7])) \
        .to(dtype)
    ref = x[:, ::stride, ::stride].reshape(-1, cin).double().t() \
        @ dcv.double()
    assert ((dw.double() - ref).abs().max() / ref.abs().max()).item() \
        <= SUM_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,stride,padding", [
    ((2, 14, 14, 512, 512), 2, "SAME"), ((2, 14, 14, 512, 512), 2, 1),
    ((1, 5, 300, 16, 8), 1, 1), ((1, 5, 300, 16, 8), 2, "SAME"),
    ((4, 7, 7, 136, 24), 1, 1)],
    ids=["Cin512-s2-SAME", "Cin512-s2-int", "wide-row", "wide-row-s2",
         "three-images-a-tile"])
def test_conv3x3_kernel_at_wide_rows_and_deep_inputs(card, dtype, shape,
                                                     stride, padding):
    """B8 at Cin 512 stride 2 (eight channel chunks, a tile across image
    boundaries), at a row wider than one tile (walked in segments) and with
    tiles over three image boundaries: against the plain version within
    CONV_TOL, relu on and off."""
    N, H, W, cin, cout = shape
    x, w, scale, shift = conv_case(card, N, H, W, cin, cout, 3, dtype)
    for relu in (True, False):
        before = conv3x3_bn_relu.launches
        got = conv3x3_bn_relu(x, w, scale, shift, stride, padding, relu)
        ref = conv_bn_relu_plain(x, w, scale, shift, stride, padding, relu)
        torch.cuda.synchronize()
        assert conv3x3_bn_relu.launches == before + 1
        assert got.shape == ref.shape
        assert conv_rel_err(got, ref) <= CONV_TOL[dtype], relu


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,padding", [((2, 28, 28, 64, 128), "SAME"),
                                           ((2, 28, 28, 64, 128), 1),
                                           ((3, 14, 13, 24, 72), 1)])
def test_conv3x3_dx_walk_at_stride_2(card, dtype, shape, padding):
    """B8 as the training 3x3 dX walk at stride 2: over the dConv dilated
    by the stride, at padding 2 against the flipped, In/Out-swapped filter
    (scale 1, shift 0, no ReLU), against the plain version within
    CONV_TOL; cropped, it is torch's conv2d_input of the undilated dConv
    (fp32, TF32 off)."""
    from paddle_tpu_torch.ops.conv import normalize_conv_padding

    N, H, W, cin, cout = shape
    x, w, _, _ = conv_case(card, N, H, W, cin, cout, 3, dtype)
    (pt, pb), (pl, pr) = normalize_conv_padding(padding, 3, 2, (H, W))
    Ho, Wo = (H + pt + pb - 3) // 2 + 1, (W + pl + pr - 3) // 2 + 1
    g = torch.randn((N, Ho, Wo, cout), generator=card, device="cuda") \
        .to(dtype)
    dil = g.new_zeros((N, 2 * Ho - 1, 2 * Wo - 1, cout))
    dil[:, ::2, ::2] = g
    wflip = w.flip(0, 1).transpose(2, 3).contiguous()
    one = torch.ones(cin, device="cuda")
    zero = torch.zeros(cin, device="cuda")
    got = conv3x3_bn_relu(dil, wflip, one, zero, 1, 2, relu=False)
    ref = conv_bn_relu_plain(dil, wflip, one, zero, 1, 2, False)
    torch.cuda.synchronize()
    assert conv_rel_err(got, ref) <= CONV_TOL[dtype]
    dxp = torch.nn.grad.conv2d_input(
        (N, cin, H + pt + pb, W + pl + pr), w.permute(3, 2, 0, 1).float(),
        g.permute(0, 3, 1, 2).float(), 2)
    want = dxp.permute(0, 2, 3, 1)[:, :got.shape[1], :got.shape[2]]
    assert conv_rel_err(got, want) <= CONV_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["int", "SAME", "VALID"])
@pytest.mark.parametrize("shape", [(3, 7, 7, 24, 72), (2, 28, 19, 64, 136),
                                   (2, 7, 7, 512, 64), (1, 5, 300, 16, 8)],
                         ids=["M147", "M1064-or-266", "Cin512", "wide-row"])
def test_conv3x3_dw_kernel_matches_plain(card, dtype, stride, padding,
                                         shape):
    """B11 against `conv3x3_dw_plain`: the nine taps' dw within SUM_TOL of
    max |dw|, with the halo of every padding read as zero; a row wider than
    the bf16 kernel's chunk is walked in segments."""
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


def dw_fp64(x, g, stride, pads):
    """conv3x3_dw_plain's nine tap products in fp64: [3, 3, Cin, Cout]."""
    (pt, pb), (pl, pr) = pads
    N, Ho, Wo, cout = g.shape
    cin = x.shape[3]
    xp = torch.nn.functional.pad(x.double(), (0, 0, pl, pr, pt, pb))
    gd = g.reshape(-1, cout).double()
    ref = torch.empty((3, 3, cin, cout), dtype=torch.float64, device="cuda")
    for dy in range(3):
        for dx in range(3):
            xs = xp[:, dy:dy + stride * (Ho - 1) + 1:stride,
                    dx:dx + stride * (Wo - 1) + 1:stride]
            ref[dy, dx] = xs.reshape(-1, cin).t() @ gd
    return ref


# bench_ops.py's seven ResNet-50 3x3 sweep shapes: (hw, cin, cout, stride)
DW_SWEEP = [(56, 64, 64, 1), (56, 128, 128, 2), (28, 128, 128, 1),
            (28, 256, 256, 2), (14, 256, 256, 1), (14, 512, 512, 2),
            (7, 512, 512, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DW_SWEEP,
                         ids=[f"{h}x{h}-{ci}-{co}-s{s}"
                              for h, ci, co, s in DW_SWEEP])
def test_conv3x3_dw_kernel_at_the_sweep_shapes(card, dtype, shape):
    """B11 at the sweep shapes at batch 2, SAME padding (the bf16 path on
    the tensor cores, f32 in fp32 FMA): within SUM_TOL of max |dw| of the
    plain version and of an fp64 reference; the same bits on a rerun."""
    from paddle_tpu_torch.ops.conv import normalize_conv_padding

    hw, cin, cout, stride = shape
    N = 2
    x, _, _, _ = conv_case(card, N, hw, hw, cin, cout, 3, dtype)
    pads = normalize_conv_padding("SAME", 3, stride, (hw, hw))
    Ho = Wo = -(-hw // stride)
    g = torch.randn((N, Ho, Wo, cout), generator=card, device="cuda") \
        .to(dtype)
    before = conv3x3_dw.launches
    dw = conv3x3_dw(x, g, stride, "SAME")
    again = conv3x3_dw(x, g, stride, "SAME")
    ref = conv3x3_dw_plain(x, g, stride, "SAME")
    torch.cuda.synchronize()
    assert conv3x3_dw.launches == before + 2
    assert conv_rel_err(dw, ref) <= SUM_TOL
    ref64 = dw_fp64(x, g, stride, pads)
    assert ((dw.double() - ref64).abs().max()
            / ref64.abs().max()).item() <= SUM_TOL
    assert torch.equal(dw, again)


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


# ---------------------------------------------------------------------------
# the sampler's draws and the int8-weight linear
# ---------------------------------------------------------------------------
def _draw_case(card, N, V):
    lg = torch.randn((N, V), generator=card, device="cuda") * 3
    lg[:, ::7] = -torch.inf                     # masked entries
    keys = torch.randint(0, 2**32, (N, 2), generator=card, device="cuda",
                         dtype=torch.int64)
    pos = torch.randint(0, 2048, (N,), generator=card, device="cuda",
                        dtype=torch.int32)
    return lg, keys, pos


@pytest.mark.parametrize("N,V", [(8, 50304), (40, 50304), (1, 1), (3, 5),
                                 (13, 333), (40, 1000), (7, 50257),
                                 (1, 50257), (8, 1003), (40, 50257),
                                 (4096, 1003)])
@pytest.mark.parametrize("exclude", [False, True])
def test_sample_draw_kernel_matches_plain(card, N, V, exclude):
    lg, keys, pos = _draw_case(card, N, V)
    ex = None
    if exclude:
        ex = lg.argmax(-1).to(torch.int32)
        ex[::2] = -1
    launches = sample_draw.launches
    got = sample_draw(lg, keys, pos, 0, ex)
    torch.cuda.synchronize()
    assert sample_draw.launches == launches + 1
    want = sample_draw_plain(lg, keys, pos, 0, ex)
    assert torch.equal(got, want)
    assert torch.equal(sample_draw(lg, keys, pos, 0, ex), got)
    if exclude and V > 1:
        live = ex >= 0
        assert (got[live] != ex[live]).all()


def test_sample_draw_ties_take_the_lowest_index(card):
    """An all -inf row (top-k 1 with its token excluded) draws index 0, as
    jnp.argmax does; a row with one finite entry draws it."""
    N, V = 4, 300
    lg = torch.full((N, V), -torch.inf, device="cuda")
    lg[1, 77] = 0.0
    keys = torch.zeros((N, 2), dtype=torch.int64, device="cuda")
    pos = torch.arange(N, dtype=torch.int32, device="cuda")
    got = sample_draw(lg, keys, pos, 0)
    assert got.tolist() == [0, 77, 0, 0]
    assert torch.equal(got, sample_draw_plain(lg, keys, pos, 0))


@pytest.mark.parametrize("N,V", [(1, 1), (8, 50304), (40, 50304),
                                 (129, 1003), (3, 5)])
@pytest.mark.parametrize("exclude", [False, True])
def test_verify_draws_kernel_bitwise_plain(card, N, V, exclude):
    """The fused launch: its tokens are the coin-free draw's and the plain
    draw's, its coins bitwise the plain uniform's under the accept salt,
    one launch and no plain call."""
    lg, keys, pos = _draw_case(card, N, V)
    ex = None
    if exclude:
        ex = lg.argmax(-1).to(torch.int32)
        ex[::2] = -1
    launches, plain = verify_draws.launches, verify_draws.plain_calls
    draws = sample_draw.launches
    tok, u = verify_draws(lg, keys, pos, ex)
    torch.cuda.synchronize()
    assert (verify_draws.launches - launches, verify_draws.plain_calls
            - plain, sample_draw.launches - draws) == (1, 0, 0)
    want = sample_uniform_plain(keys, pos, SALT_ACCEPT)
    assert torch.equal(u.view(torch.int32), want.view(torch.int32))
    assert ((u >= 0) & (u < 1)).all()
    assert torch.equal(tok, sample_draw_plain(lg, keys, pos, SALT_SAMPLE, ex))
    assert torch.equal(tok, sample_draw(lg, keys, pos, SALT_SAMPLE, ex))


def test_sampling_kernels_refuse_what_they_do_not_take(card):
    lg, keys, pos = _draw_case(card, 4, 64)
    for bad in (dict(lg=lg.bfloat16()), dict(lg=lg[:, ::2]),
                dict(keys=keys.int()), dict(pos=pos.long()),
                dict(keys=keys[:3])):
        a = {**dict(lg=lg, keys=keys, pos=pos), **bad}
        with pytest.raises(ValueError):
            sample_draw(a["lg"], a["keys"], a["pos"], 0)
    with pytest.raises(ValueError, match="exclude"):
        sample_draw(lg, keys, pos, 0, torch.zeros(4, device="cuda"))
    with pytest.raises(ValueError):
        verify_draws(lg, keys, pos.long())
    with pytest.raises(ValueError, match="exclude"):
        verify_draws(lg, keys, pos, torch.zeros(4, device="cuda"))
    with pytest.raises(ValueError):
        verify_draws(lg.bfloat16(), keys, pos)


def test_sampled_engine_on_the_card_matches_the_cpu(card):
    """A tiny f32 GPT with greedy and sampled lanes, K=0 and K=2: the card's
    engine (the draw kernels: one coin-free draw a decode step and a final
    prefill chunk, one fused draw and coin a verify step, no plain call)
    emits the CPU engine's streams."""
    from paddle_tpu_torch import GenerationEngine, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.inference import SamplingParams

    cfg = GPTConfig.tiny(vocab=96, hidden=64, layers=2, heads=4, seq=64)
    model = GPTForCausalLM(cfg, device="cuda", generator=card).eval()
    host = GPTForCausalLM(cfg, device="cpu").eval()
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, 96, (n,), generator=rng).tolist()
               for n in (5, 17, 9, 12)]

    def serve(m, dev, K):
        eng = GenerationEngine(m, device=dev, num_slots=3, block_size=8,
                               sampling=True, spec_decode_k=K)
        ids = [eng.add_request(p, 10, sampling_params=None if i % 2 else
                               SamplingParams(0.8, 20, 0.9, seed=i))
               for i, p in enumerate(prompts)]
        out = eng.run()
        return [out[r] for r in ids], eng

    for K in (0, 2):
        counts = [(w.launches, w.plain_calls)
                  for w in (sample_draw, verify_draws)]
        got, eng = serve(model, "cuda", K)
        torch.cuda.synchronize()
        (d0, dp), (v0, vp) = counts
        assert sample_draw.plain_calls == dp
        assert verify_draws.plain_calls == vp
        assert sample_draw.launches - d0 == \
            (0 if K else eng.decode_steps) + eng.prefill_first_tokens
        assert verify_draws.launches - v0 == (eng.decode_steps if K else 0)
        assert got == serve(host, "cpu", K)[0]


INT8_LINEAR_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def _int8_linear_case(card, dtype, M, N, K):
    w = torch.randn((N, K), generator=card, device="cuda") * 0.02
    q, s = quantize_absmax(w.to(dtype), axis=0)
    x = torch.randn((M, K), generator=card, device="cuda").to(dtype)
    b = (torch.randn((N,), generator=card, device="cuda") * 0.1).to(dtype)
    return x, q, s, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,N,K", [(1, 64, 64), (8, 200, 48), (40, 72, 80),
                                   (17, 1, 16), (128, 130, 272),
                                   (130, 6144, 2048), (8, 2048, 8192)])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear_kernel_matches_plain(card, dtype, M, N, K, bias):
    """max |kernel - plain| relative to max |plain|: both sum exact fp32
    products of the same dequantized weights in fp32, in other orders; a
    bf16 output may then round the other way (2^-7 of max |plain|), and
    the bias adds one bf16 rounding in both; f32 as the other kernels'."""
    x, q, s, b = _int8_linear_case(card, dtype, M, N, K)
    b = b if bias else None
    launches = int8_linear.launches
    got = int8_linear(x, q, s, b)
    torch.cuda.synchronize()
    assert int8_linear.launches == launches + 1
    want = int8_linear_plain(x, q, s, b)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= INT8_LINEAR_TOL[dtype] * want.float().abs().max().item()
    assert torch.equal(int8_linear(x, q, s, b), got)


@pytest.mark.parametrize("M", [1, 5, 8, 9, 16, 17, 40, 128])
@pytest.mark.parametrize("N,K", [(100, 16), (200, 1040), (1000, 2064),
                                 (330, 8192)])
def test_int8_linear_split_plan_is_exact_and_shards_bitwise(card, M, N, K):
    """The bf16 kernel's K split over a cluster (`_plan`: 1 to 8 ranks
    here) at ragged N, K not of 64: within INT8_LINEAR_TOL of the
    plain version, a rerun the same bits, and each half's launch (the
    codes, scales and bias of N / 2 channels, as a tensor-parallel shard
    holds them) bitwise the whole launch's columns."""
    x, q, s, b = _int8_linear_case(card, torch.bfloat16, M, N, K)
    got = int8_linear(x, q, s, b)
    want = int8_linear_plain(x, q, s, b)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= INT8_LINEAR_TOL[torch.bfloat16] * \
        want.float().abs().max().item()
    assert torch.equal(int8_linear(x, q, s, b), got)
    n = N // 2
    for cols in (slice(0, n), slice(n, N)):
        half = int8_linear(x, q[cols].contiguous(), s[cols].contiguous(),
                           b[cols].contiguous())
        assert torch.equal(half.view(torch.int16),
                           got[:, cols].contiguous().view(torch.int16))


def test_int8_linear_takes_leading_dims_and_refuses_the_rest(card):
    x, q, s, b = _int8_linear_case(card, torch.bfloat16, 10, 48, 32)
    got = int8_linear(x.view(2, 5, 32), q, s, b)
    assert got.shape == (2, 5, 48)
    assert torch.equal(got.view(10, 48), int8_linear(x, q, s, b))
    for args in ((x[:, :24], q[:, :24], s, b),            # K not of 16
                 (x.half(), q, s.half(), b.half()),
                 (x, q.float(), s, b), (x, q, s.float(), b),
                 (x, q, s, b.float()), (x, q[:, ::2], s, b)):
        with pytest.raises(ValueError):
            int8_linear(*args)


def test_int8_weight_engine_launches_four_a_layer(card):
    from paddle_tpu_torch import GenerationEngine, GPTConfig, GPTForCausalLM

    cfg = GPTConfig.tiny(vocab=96, hidden=64, layers=3, heads=4, seq=64)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=card).eval()
    eng = GenerationEngine(model, num_slots=2, block_size=8,
                           weight_dtype="int8")
    launches, plain = int8_linear.launches, int8_linear.plain_calls
    eng.add_request(list(range(1, 12)), 6)
    out = eng.run()
    torch.cuda.synchronize()
    steps = eng.prefill_chunks + eng.decode_steps
    assert int8_linear.launches - launches == 4 * 3 * steps
    assert int8_linear.plain_calls == plain
    assert len(next(iter(out.values()))) == 17


# ---------------------------------------------------------------------------
# bucketed prefill and the batched LoRA kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [16, 32, 48])
def test_causal_kernel_at_the_short_buckets(card, dtype, S):
    """B1 at the engine's shape (16 heads, D 128) and the bucket ladder's
    short lengths, which the engine's bucketed prefill hands it."""
    q, k, v = (torch.randn((16, S, 128), generator=card,
                           device="cuda").to(dtype) for _ in range(3))
    o_ref, l_ref = causal_attention_plain(q, k, v, 128 ** -0.5)
    o, lse = causal_attention_fwd(q, k, v, 128 ** -0.5)
    torch.cuda.synchronize()
    assert (o.float() - o_ref.float()).abs().max().item() <= TOL[dtype]
    lse_tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    assert (lse - l_ref).abs().max().item() <= lse_tol


def test_bucketed_engine_launches_the_causal_kernel_a_layer(card):
    from paddle_tpu_torch import GenerationEngine, GPTConfig, GPTForCausalLM

    cfg = GPTConfig.tiny(vocab=96, hidden=256, layers=3, heads=2, seq=64)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=card).eval()
    eng = GenerationEngine(model, num_slots=2, block_size=16,
                           prefill_chunk=None)
    launches = causal_attention_fwd.launches
    plain = causal_attention_fwd.plain_calls
    for n in (5, 17, 40):
        eng.add_request(list(range(1, n + 1)), 4)
    out = eng.run()
    torch.cuda.synchronize()
    assert causal_attention_fwd.launches - launches == 3 * eng.admissions == 9
    assert causal_attention_fwd.plain_calls == plain
    assert sorted(len(t) for t in out.values()) == [9, 21, 44]


# (in, out, heads of a head-grouped B or 0)
LORA_SHAPES = [(48, 80, 0), (64, 96, 2), (96, 3 * 64, 4), (2048, 6144, 16),
               (8192, 2048, 0), (40, 1030, 0), (2052, 1030, 0)]


def _lora_case(card, n_in, n_out, heads, R, B, S, dtype, pages=5):
    """Pools of `pages` pages over 2 layers (page p's rank rows past
    1 + p % R zero, page 0 zero, scaling 0), x and a base; slots on pages
    cycling through 0..pages-1."""
    a = torch.randn((pages, 2, R, n_in), generator=card, device="cuda") \
        / math.sqrt(n_in)
    b = torch.randn((pages, 2, R, n_out), generator=card, device="cuda")
    for p in range(pages):
        r = 0 if p == 0 else 1 + p % R
        a[p, :, r:] = 0
        b[p, :, r:] = 0
    if heads:
        b = b.view(pages, 2, R, heads, 3, n_out // (3 * heads))
    sc = torch.rand((pages,), generator=card, device="cuda") + 0.5
    sc[0] = 0
    rows = torch.tensor([(i * 3 + 1) % pages for i in range(B)],
                        dtype=torch.int32, device="cuda")
    x = torch.randn((B, S, n_in), generator=card, device="cuda")
    base = torch.randn((B, S, n_out), generator=card, device="cuda")
    return (a.to(dtype).contiguous(), b.to(dtype).contiguous(), sc, rows,
            x.to(dtype), base.to(dtype))


@pytest.mark.parametrize("n_in,n_out,heads", LORA_SHAPES)
@pytest.mark.parametrize("R", [1, 4, 16, 64])
@pytest.mark.parametrize("B,S", [(8, 1), (8, 5), (1, 128), (3, 9), (2, 17),
                                 (1, 300)])
def test_lora_kernel_matches_plain(card, n_in, n_out, heads, R, B, S):
    """max |kernel delta - plain delta| within 2e-6 of max |plain delta|
    at 2048 inputs (fp32 sums of the same exact products in other orders),
    a bar that grows with the square root of the shrink's length (a sum of
    8192 products read 2.4e-6 of it on an H100); the bf16 result bitwise
    the plain version's where the fp32 deltas round to the same bf16; null
    rows bitwise the base."""
    a, b, sc, rows, x, base = _lora_case(card, n_in, n_out, heads, R, B, S,
                                         torch.bfloat16)
    a32, b32 = a.float(), b.float()
    zero = torch.zeros((B, S, n_out), device="cuda")
    launches = batched_lora.launches
    dk = batched_lora(zero, x.float(), a32, b32, rows, sc, 1)
    dp = batched_lora_plain(torch.zeros_like(zero), x.float(), a32, b32,
                            rows, sc, 1)
    got = batched_lora(base.clone(), x, a, b, rows, sc, 1)
    want = batched_lora_plain(base.clone(), x, a, b, rows, sc, 1)
    torch.cuda.synchronize()
    assert batched_lora.launches == launches + 2 and dk is zero
    tol = 2e-6 * max(1.0, math.sqrt(n_in / 2048))
    assert (dk - dp).abs().max().item() <= tol * dp.abs().max().item()
    alike = dk.to(torch.bfloat16) == dp.to(torch.bfloat16)
    assert alike.float().mean().item() > 0.99
    assert torch.equal(got[alike], want[alike])
    null = (rows == 0)[:, None, None].expand_as(base)
    assert torch.equal(got[null], base[null])
    assert torch.equal(batched_lora(base.clone(), x, a, b, rows, sc, 1), got)


@pytest.mark.parametrize("n_in,S", [(2052, 5), (8192, 1), (2048, 128)])
def test_lora_kernel_takes_an_unaligned_x(card, n_in, S):
    """x off a 16-byte boundary (a contiguous view 2 bytes into its
    buffer) takes the plain-load route to shared memory, with the bulk
    route's bits: the sum order does not depend on the route."""
    a, b, sc, rows, x, base = _lora_case(card, n_in, 2048, 0, 16, 4, S,
                                         torch.bfloat16)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    got = batched_lora(base.clone(), shifted, a, b, rows, sc, 1)
    want = batched_lora(base.clone(), x, a, b, rows, sc, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_lora_kernel_all_null_batch_leaves_the_base(card):
    """Every slot on the null page: one launch, and the base keeps its
    bits."""
    a, b, sc, rows, x, base = _lora_case(card, 2048, 8192, 0, 16, 8, 5,
                                         torch.bfloat16)
    rows.zero_()
    launches = batched_lora.launches
    got = batched_lora(base.clone(), x, a, b, rows, sc, 1)
    torch.cuda.synchronize()
    assert batched_lora.launches == launches + 1
    assert torch.equal(got.view(torch.int16), base.view(torch.int16))


def test_lora_kernel_rows_do_not_depend_on_other_slots(card):
    """A slot's rows come out the same bits whatever pages the other slots
    hold (a mixed-tenant batch gives each request its dedicated bits)."""
    a, b, sc, rows, x, base = _lora_case(card, 2048, 6144, 16, 16, 8, 5,
                                         torch.bfloat16, pages=9)
    got = batched_lora(base.clone(), x, a, b, rows, sc, 0)
    other = rows.clone()
    other[1:] = torch.tensor([8, 7, 6, 5, 4, 3, 2], dtype=torch.int32)
    alone = batched_lora(base.clone(), x, a, b, other, sc, 0)
    assert torch.equal(got[0], alone[0])


def test_lora_kernel_refuses_what_it_does_not_take(card):
    a, b, sc, rows, x, base = _lora_case(card, 48, 80, 0, 4, 2, 3,
                                         torch.bfloat16)
    R = LORA_MAX_RANK + 1
    wide = torch.zeros((5, 2, R, 48), dtype=torch.bfloat16, device="cuda")
    for args in ((base, x.float(), a, b, rows, sc, 1),     # dtypes differ
                 (base.half(), x.half(), a.half(), b.half(), rows, sc, 1),
                 (base, x, a, b, rows.long(), sc, 1),
                 (base, x, a, b, rows, sc.double(), 1),
                 (base, x, a, b, rows, sc, 2),              # no layer 2
                 (base[:, :, :40], x, a, b, rows, sc, 1),
                 (base, x, wide, wide[..., :1].expand(5, 2, R, 80)
                  .contiguous(), rows, sc, 1),
                 (base, x.transpose(1, 2).contiguous().transpose(1, 2), a,
                  b, rows, sc, 1)):
        with pytest.raises(ValueError):
            batched_lora(*args)


# GPT-1.3B's LoRA sites (in, out, heads of the head-grouped B or 0)
LORA_SITES_1P3B = {"qkv": (2048, 6144, 16), "out": (2048, 2048, 0),
                   "fc1": (2048, 8192, 0), "fc2": (8192, 2048, 0)}


@pytest.mark.parametrize("site", list(LORA_SITES_1P3B))
@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("B,S", [(8, 1), (8, 5), (1, 128)])
def test_lora_kernel_on_a_b_shard(card, site, mp, B, S):
    """A tensor-parallel shard's launch over its B columns (`out / mp`:
    512 at out and fc2 at mp 4; qkv head-major, its heads' [3, D] rows, the
    shard's pages flattened) gives the whole launch's columns bit for bit,
    bf16 at rank 16, and matches its plain version."""
    n_in, n_out, heads = LORA_SITES_1P3B[site]
    a, b, sc, rows, x, base = _lora_case(card, n_in, n_out, heads, 16, B,
                                         S, torch.bfloat16, pages=9)
    whole = batched_lora(base.clone(), x, a, b, rows, sc, 1)
    n = n_out // mp
    for r in range(mp):
        if heads:
            lh, D = heads // mp, n_out // (3 * heads)
            bs = b[:, :, :, r * lh:(r + 1) * lh].contiguous().flatten(3)
            # the 3-major base regrouped head-major: the shard's columns
            grouped = base.view(B, S, 3, heads, D).permute(0, 1, 3, 2, 4)
            part = grouped[:, :, r * lh:(r + 1) * lh].reshape(B, S, n)
            want = whole.view(B, S, 3, heads, D).permute(0, 1, 3, 2, 4)[
                :, :, r * lh:(r + 1) * lh].reshape(B, S, n)
        else:
            bs = b[..., r * n:(r + 1) * n].contiguous()
            part = base[..., r * n:(r + 1) * n]
            want = whole[..., r * n:(r + 1) * n]
        launches = batched_lora.launches
        got = batched_lora(part.clone(), x, a, bs, rows, sc, 1)
        plain = batched_lora_plain(part.clone(), x, a, bs, rows, sc, 1)
        torch.cuda.synchronize()
        assert batched_lora.launches == launches + 1
        assert torch.equal(got, want)
        assert (got.float() - plain.float()).abs().max().item() \
            <= 2.0 ** -7 * plain.float().abs().max().item()


def test_tp_engine_on_a_virtual_mesh_of_the_card_matches_the_cpu(card):
    """f32 engines at mp 2 and 4 on a virtual mesh of the card (the paged
    kernels at the shard's heads, B1 at bucketed admissions, the LoRA
    kernel on B shards) and on the CPU (their plain versions) from the
    same weights and adapters: the same tokens, each kernel once a shard."""
    import numpy as np

    from paddle_tpu_torch import GenerationEngine, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.adapters import AdapterRegistry
    from paddle_tpu_torch.distributed import serving_mesh

    cfg = GPTConfig.tiny(vocab=96, hidden=256, layers=2, heads=4, seq=128)
    model = GPTForCausalLM(cfg, device="cuda", generator=card).eval()
    host = GPTForCausalLM(cfg, device="cpu").eval()
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.RandomState(0)
    reg = AdapterRegistry(cfg, max_rank=8)
    H, I = cfg.hidden_size, cfg.intermediate_size
    reg.register(1, {site: [(rng.randn(4, i).astype(np.float32) * 0.1,
                             rng.randn(o, 4).astype(np.float32) * 0.1)
                            for _ in range(cfg.num_layers)]
                     for site, (i, o) in (("qkv", (H, 3 * H)),
                                          ("out", (H, H)), ("fc1", (H, I)),
                                          ("fc2", (I, H)))}, scaling=0.5)
    reqs = [(rng.randint(0, 96, n), m, a) for n, m, a in
            ((7, 5, 1), (40, 4, 0), (19, 6, 1))]

    def serve(m, mesh, **kw):
        eng = GenerationEngine(m, device=mesh.devices[0].type, mesh=mesh,
                               num_slots=2, block_size=16, adapters=reg,
                               **kw)
        ids = [eng.add_request(p, n, adapter_id=a) for p, n, a in reqs]
        out = eng.drain()
        return [out[i] for i in ids], eng

    for mp in (2, 4):
        for kw in (dict(spec_decode_k=2), dict(prefill_chunk=None)):
            before = {f: f.launches for f in (paged_decode_attention,
                                              paged_verify_attention,
                                              causal_attention_fwd,
                                              batched_lora)}
            got, eng = serve(model, serving_mesh(mp, devices=["cuda"] * mp),
                             **kw)
            torch.cuda.synchronize()
            want, _ = serve(host, serving_mesh(mp, devices=["cpu"] * mp), **kw)
            assert got == want
            ran = {f: f.launches - n for f, n in before.items()}
            paged = paged_verify_attention if kw.get("spec_decode_k") \
                else paged_decode_attention
            assert ran[paged] == 2 * mp * eng.decode_steps
            fwd = eng.prefill_chunks + eng.decode_steps
            if "prefill_chunk" in kw:
                assert ran[causal_attention_fwd] == 2 * mp * eng.admissions
                fwd += eng.admissions
            assert ran[batched_lora] == 4 * 2 * mp * fwd


def test_tp_engine_across_cards_matches_a_virtual_mesh(card):
    """On a host with several cards: the mesh `cuda:0 .. cuda:mp-1` (each
    shard's kernels on its own card, the gathers across cards) serves the
    tokens of the same mesh run virtually on one card, f32, at mp 2 and 4
    (as the host has cards), fp and int8 pools, with adapters and a
    sampled lane; the kernels launch once a shard."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more cards, the host has {n}")
    import numpy as np

    from paddle_tpu_torch import GenerationEngine, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.adapters import AdapterRegistry
    from paddle_tpu_torch.distributed import serving_mesh
    from paddle_tpu_torch.inference import SamplingParams

    cfg = GPTConfig.tiny(vocab=96, hidden=256, layers=2, heads=4, seq=128)
    model = GPTForCausalLM(cfg, device="cuda:0", generator=card).eval()
    rng = np.random.RandomState(0)
    reg = AdapterRegistry(cfg, max_rank=8)
    H, I = cfg.hidden_size, cfg.intermediate_size
    reg.register(1, {site: [(rng.randn(4, i).astype(np.float32) * 0.1,
                             rng.randn(o, 4).astype(np.float32) * 0.1)
                            for _ in range(cfg.num_layers)]
                     for site, (i, o) in (("qkv", (H, 3 * H)),
                                          ("out", (H, H)), ("fc1", (H, I)),
                                          ("fc2", (I, H)))}, scaling=0.5)
    reqs = [(rng.randint(0, 96, n_), m, a) for n_, m, a in
            ((7, 5, 1), (40, 4, 0), (19, 6, 1))]
    sp = SamplingParams(temperature=0.8, top_k=20, seed=5)

    def serve(mesh, **kw):
        eng = GenerationEngine(model, mesh=mesh, num_slots=2, block_size=16,
                               adapters=reg, sampling=True, **kw)
        ids = [eng.add_request(p, m, adapter_id=a,
                               sampling_params=sp if i == 2 else None)
               for i, (p, m, a) in enumerate(reqs)]
        out = eng.drain()
        return [out[i] for i in ids]

    for mp in [m for m in (2, 4) if m <= n]:
        for kw in (dict(spec_decode_k=2), dict(kv_dtype="int8",
                                                prefill_chunk=None)):
            launches = batched_lora.launches
            cards = serve(serving_mesh(mp), **kw)
            across = batched_lora.launches - launches
            launches = batched_lora.launches
            virtual = serve(serving_mesh(mp, devices=["cuda:0"] * mp), **kw)
            assert cards == virtual
            assert across == batched_lora.launches - launches


def test_lora_engine_on_the_card_matches_the_cpu(card):
    """Mixed tenants through a f32 engine on the card (the kernel) and on
    the CPU (its plain version) from the same weights and adapters, chunked
    and bucketed: the same tokens, four launches a layer a step."""
    import numpy as np

    from paddle_tpu_torch import GenerationEngine, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.adapters import AdapterRegistry

    cfg = GPTConfig.tiny(vocab=96, hidden=128, layers=2, heads=2, seq=64)
    model = GPTForCausalLM(cfg, device="cuda", generator=card).eval()
    host = GPTForCausalLM(cfg, device="cpu").eval()
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.RandomState(0)
    reg = AdapterRegistry(cfg, max_rank=8)
    H, I = cfg.hidden_size, cfg.intermediate_size
    for aid, r in ((1, 4), (2, 8)):
        reg.register(aid, {site: [(rng.randn(r, i).astype(np.float32) * 0.1,
                                   rng.randn(o, r).astype(np.float32) * 0.1)
                                  for _ in range(cfg.num_layers)]
                           for site, (i, o) in (("qkv", (H, 3 * H)),
                                                ("out", (H, H)),
                                                ("fc1", (H, I)),
                                                ("fc2", (I, H)))},
                     scaling=0.5)
    reqs = [(rng.randint(0, 96, n), m, a) for n, m, a in
            ((7, 5, 1), (20, 4, 0), (12, 6, 2), (30, 3, 1))]

    def serve(m, dev, **kw):
        eng = GenerationEngine(m, device=dev, num_slots=2, block_size=16,
                               adapters=reg, **kw)
        ids = [eng.add_request(p, n, adapter_id=a) for p, n, a in reqs]
        out = eng.drain()
        return [out[i] for i in ids], eng

    for kw in (dict(prefill_chunk=8), dict(prefill_chunk=None)):
        launches = batched_lora.launches
        got, eng = serve(model, "cuda", **kw)
        torch.cuda.synchronize()
        # a forward a prefill chunk, a bucketed admission, a decode step
        steps = eng.prefill_chunks + eng.decode_steps + (
            0 if eng.chunked_prefill else eng.admissions)
        assert batched_lora.launches - launches == 4 * 2 * steps
        assert got == serve(host, "cpu", **kw)[0]


@pytest.mark.parametrize("kw", [
    dict(), dict(spec_decode_k=2, sampling=True), dict(kv_dtype="int8"),
    dict(adapters=True, adapter_pool_pages=3)],
    ids=["k0", "k2_sampled", "kv8", "adapters"])
def test_async_core_makes_no_host_sync_after_its_dispatch(card, kw):
    """The async core on the card: its post-dispatch stages (the dispatch
    with its staged uploads and readback, the adapter prefetch, the end
    of step gauges, the phase flush) run under
    `set_sync_debug_mode("error")` without a raise, and the tokens and
    kernel launches are the serial core's."""
    import numpy as np

    from paddle_tpu_torch import GenerationEngine, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.adapters import AdapterRegistry
    from paddle_tpu_torch.inference import SamplingParams

    cfg = GPTConfig.tiny(vocab=96, hidden=128, layers=2, heads=2, seq=64)
    model = GPTForCausalLM(cfg, device="cuda", generator=card).eval()
    rng = np.random.RandomState(1)
    ids_of = (1, 2, 0, 3, 1, 2)
    if kw.get("adapters"):
        reg = AdapterRegistry(cfg, max_rank=4)
        H, I = cfg.hidden_size, cfg.intermediate_size
        for aid in (1, 2, 3):
            reg.register(aid, {site: [(rng.randn(4, i).astype(np.float32)
                                       * 0.1, rng.randn(o, 4)
                                       .astype(np.float32) * 0.1)
                                      for _ in range(cfg.num_layers)]
                               for site, (i, o) in (("qkv", (H, 3 * H)),
                                                    ("out", (H, H)),
                                                    ("fc1", (H, I)),
                                                    ("fc2", (I, H)))},
                         scaling=0.5)
        kw = dict(kw, adapters=reg)
    reqs = [rng.randint(0, 96, n) for n in (7, 20, 12, 30, 5, 9)]

    def serve(async_core):
        eng = GenerationEngine(model, num_slots=2, block_size=16,
                               prefill_chunk=16, async_core=async_core, **kw)
        if async_core:
            for name in ("_dispatch_ahead", "_prefetch_ahead",
                         "_end_of_step_gauges", "_flush_step_phases"):
                def wrapped(*a, _fn=getattr(eng, name), **k):
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        return _fn(*a, **k)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                setattr(eng, name, wrapped)
        before = (paged_decode_attention.launches,
                  paged_decode_attention_int8.launches,
                  paged_verify_attention.launches, batched_lora.launches,
                  sample_draw.launches, verify_draws.launches)
        ids = []
        for i, p in enumerate(reqs):
            extra = {}
            if kw.get("sampling"):
                extra["sampling_params"] = None if i % 2 else \
                    SamplingParams(0.8, 20, 0.9, seed=i)
            if kw.get("adapters"):
                extra["adapter_id"] = ids_of[i]
            ids.append(eng.add_request(p, 6, **extra))
        out = eng.drain()
        torch.cuda.synchronize()
        after = (paged_decode_attention.launches,
                 paged_decode_attention_int8.launches,
                 paged_verify_attention.launches, batched_lora.launches,
                 sample_draw.launches, verify_draws.launches)
        return ([out[i] for i in ids], [a - b for a, b in zip(after, before)],
                eng)

    serial, s_launches, _ = serve(False)
    got, a_launches, eng = serve(True)
    assert got == serial and a_launches == s_launches
    assert sum(a_launches) > 0
    assert {e["event"] for e in eng.dump_flight_recorder()} >= {
        "async_dispatch", "async_complete"}
