"""The index arithmetic of the bf16 tensor-core conv kernels, emulated in
numpy with no compiler, against the plain versions.

`csrc/conv_bn_relu.cu`'s `conv3x3_bn_relu_mma_kernel` (B8) tiles the output
into TH consecutive output rows of TW columns and reads, per chunk of 64
input channels, one x patch for all nine taps: patch rows shared between
neighbouring output rows of an image, a new run of rows at each image
boundary inside the tile, XW columns a row. `emulate_b8` repeats the host's
choice of the tile (`launch_3x3_mma`), the kernel's patch-row table, each
lane's tap-0 slot, the zero-filled copy of the patch and the epilogue's
pixel index, line for line, and computes the conv in fp64 from the patches
alone: it must equal the fp64 conv over the zero-padded input at every
geometry the card tests use (ragged tiles, tiles across image boundaries,
rows wider than a tile, stride 2 with SAME's asymmetric halo, the training
dX walk at padding 2).

The train forwards B9b and B9a (`conv3x3_train_mma_kernel`,
`conv1x1_train_mma_kernel`) take B8's and B7's walks with a statistics
epilogue (`StatsMmaEpilogue`): each thread sums its rows of the C fragment,
the eight lanes of a column join by xor shuffles, the four pixel warps in
order, one partial row per pixel tile, then `sum_rows_kernel` adds the
tiles. `emulate_stats` repeats that order in fp32 over B8's TH x TW tiles
and B7's 128-pixel tiles: every valid pixel of every channel counts once,
the sums agree with fp64, and the tiles are the rows the wrapper
allocates (`conv_train_partial_rows`).

`csrc/conv_bn_relu_bwd.cu`'s B10 builds each chunk's dConv tile lane by
channel pair and warp by row (`build_dconv`); its dW walks each split's
pixels in chunks of 64. Both are emulated here too.
"""
import math

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from paddle_tpu_torch.ops.conv import (_splits, conv_train_partial_rows,
                                       normalize_conv_padding)

CH = 64                 # channels a tile row holds (conv_mma.cuh kCh)
FWD_PIX = 128           # kFwdPix
FWD_SLOTS = 640         # kFwdSlots
FWD_ROWS = 64           # kFwdRows
DW_STEP = 64            # kDwStep


def boundaries(TH, Ho):
    """`boundaries`: the most image boundaries TH rows starting at a
    multiple of TH cross."""
    return max((k * TH + TH - 1) // Ho - (k * TH) // Ho for k in range(Ho))


def fwd_geometry(Ho, Wo, s):
    """`launch_3x3_mma`'s tile: (TH, TW, XW, PR, nseg)."""
    TW = min(Wo, FWD_PIX, (FWD_SLOTS // 3 - 3) // s + 1)
    XW = (TW - 1) * s + 3
    nseg = -(-Wo // TW)
    TH = 1 if nseg > 1 else FWD_PIX // TW
    while True:
        PR = (TH - 1) * s + 3 + boundaries(TH, Ho) * (3 - s)
        if TH == 1 or (PR <= FWD_ROWS and PR * XW <= FWD_SLOTS):
            break
        TH -= 1
    return TH, TW, XW, PR, nseg


def row_table(N, Ho, s, pad_t, TH, PR, t0):
    """The kernel's patch-row table: (image, input row) of each patch row;
    image N where no output row of the tile reads it."""
    n0 = t0 // Ho
    table = []
    for pr in range(PR):
        n, ho, r, base = n0, t0 - n0 * Ho, 0, 0
        pn, phi = N, 0
        while r < TH:
            cnt = min(TH - r, Ho - ho)
            span = (cnt - 1) * s + 3
            if pr < base + span:
                pn, phi = n, ho * s - pad_t + (pr - base)
                break
            base += span
            r += cnt
            ho = 0
            n += 1
        table.append((pn, phi))
    return table


def emulate_b8(x, w, s, pads):
    """The mma kernel's conv in fp64 from its patches: x NHWC, w HWIO."""
    N, H, W, Cin = x.shape
    Cout = w.shape[3]
    (pt, pb), (pl, pr_) = pads
    Ho = (H + pt + pb - 3) // s + 1
    Wo = (W + pl + pr_ - 3) // s + 1
    TH, TW, XW, PR, nseg = fwd_geometry(Ho, Wo, s)
    assert PR <= FWD_ROWS and PR * XW <= FWD_SLOTS
    assert 2 * PR * XW * 128 + 4 * CH * 128 <= 232448   # shared memory
    rows_total = N * Ho
    out = np.full((N * Ho * Wo, Cout), np.nan)
    nch = -(-Cin // CH)
    wp = np.zeros((9, nch * CH, Cout))
    wp[:, :Cin] = w.reshape(9, Cin, Cout)
    for bx in range(nseg * -(-rows_total // TH)):
        rg, seg = divmod(bx, nseg)
        t0, c0 = rg * TH, seg * TW
        n0 = t0 // Ho
        table = row_table(N, Ho, s, pt, TH, PR, t0)
        # each pixel p of the CTA's 128 rows: its tap-0 slot
        base = np.zeros(FWD_PIX, np.int64)
        for p in range(FWD_PIX):
            r, c = divmod(p, TW)
            if r < TH:
                base[p] = (r * s + ((t0 + r) // Ho - n0) * (3 - s)) * XW \
                    + c * s
        offs = np.array([(tap // 3) * XW + tap % 3 for tap in range(9)])
        slots = base[:, None] + offs[None]                 # [128, 9]
        assert slots.min() >= 0 and slots.max() < PR * XW
        acc = np.zeros((FWD_PIX, Cout))
        for kc in range(nch):
            patch = np.zeros((PR * XW, CH))
            for slot in range(PR * XW):
                prow, j = divmod(slot, XW)
                n, hi = table[prow]
                wi = c0 * s - pl + j
                if n < N and 0 <= hi < H and 0 <= wi < W:
                    ci = x[n, hi, wi, kc * CH:(kc + 1) * CH]
                    patch[slot, :ci.shape[0]] = ci
            acc += np.einsum("ptc,tcd->pd", patch[slots],
                             wp[:, kc * CH:(kc + 1) * CH])
        for p in range(FWD_PIX):
            r, c = divmod(p, TW)
            if r >= TH or t0 + r >= rows_total or c0 + c >= Wo:
                continue
            m = (t0 + r) * Wo + c0 + c
            assert np.isnan(out[m, 0]), "a pixel stored twice"
            out[m] = acc[p]
    assert not np.isnan(out).any(), "a pixel never stored"
    return out.reshape(N, Ho, Wo, Cout), (TH, TW, PR, nseg)


def conv_fp64(x, w, s, pads):
    (pt, pb), (pl, pr) = pads
    xp = F.pad(torch.from_numpy(x).permute(0, 3, 1, 2), (pl, pr, pt, pb))
    return F.conv2d(xp, torch.from_numpy(w).permute(3, 2, 0, 1),
                    stride=s).permute(0, 2, 3, 1).numpy()


# (N, H, W, Cin, Cout, stride, padding): the card tests' shapes, tiles
# across one and three image boundaries, a row wider than a tile at both
# strides, three channel chunks, and the dX walk (stride 1, padding 2) over
# a stride-2 dConv dilated to 13 x 13
B8_CASES = [(3, 7, 7, 24, 72, 1, 1), (3, 7, 7, 24, 72, 2, "SAME"),
            (2, 28, 19, 64, 136, 1, "SAME"), (2, 28, 19, 64, 136, 2, 1),
            (4, 14, 14, 16, 8, 2, "SAME"), (4, 7, 7, 136, 16, 1, 1),
            (1, 5, 300, 16, 8, 1, 1), (1, 5, 300, 16, 8, 2, "SAME"),
            (2, 13, 13, 16, 24, 1, 2), (2, 6, 6, 8, 8, 1, "VALID")]


@pytest.mark.parametrize("case", B8_CASES,
                         ids=[f"N{c[0]}-{c[1]}x{c[2]}-{c[3]}-{c[4]}-s{c[5]}-"
                              f"p{c[6]}" for c in B8_CASES])
def test_b8_patch_walk_equals_the_conv(case):
    N, H, W, cin, cout, s, padding = case
    rng = np.random.RandomState(0)
    x = rng.standard_normal((N, H, W, cin))
    w = rng.standard_normal((3, 3, cin, cout))
    pads = normalize_conv_padding(padding, 3, s, in_hw=(H, W))
    got, (TH, TW, PR, nseg) = emulate_b8(x, w, s, pads)
    want = conv_fp64(x, w, s, pads)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-10)


def test_b8_tiles_at_the_sweep_shapes():
    """At bench_ops.py's seven 3x3 sweep shapes (batch 256, SAME) and their
    training dX walks, the tile holds 112-126 of its 128 pixel rows, its
    patch fits a stage, and two stages and the filter ring fit the card's
    shared memory."""
    for hw, s in ((56, 1), (56, 2), (28, 1), (28, 2), (14, 1), (14, 2),
                  (7, 1)):
        Ho = -(-hw // s)
        for H, ss in ((hw, s), (s * (Ho - 1) + 1, 1)):      # forward, walk
            Hout = Ho if ss == s else H + 2
            TH, TW, XW, PR, nseg = fwd_geometry(Hout, Hout, ss)
            assert nseg == 1 and 112 <= TH * TW <= 128, (hw, s, TH, TW)
            assert PR * XW <= FWD_SLOTS and PR <= FWD_ROWS


@pytest.mark.parametrize("P", [128, 64])
def test_b10_dconv_build_covers_each_element_once(P):
    """`build_dconv` over a [P][64] chunk: lane pc of warp w writes channels
    2 pc, 2 pc + 1 of rows w, w + 8, ...: every element of the swizzled
    tile exactly once, each warp store one 128-byte row in 32 distinct
    banks, and each lane's bundle read (`R[q * 64 + 2 pc]`, a float2) its
    own channels."""
    seen = np.zeros((P, 64), np.int64)
    for w in range(8):
        for p in range(w, P, 8):
            banks = set()
            for pc in range(32):
                c = pc >> 2
                off = p * 128 + ((c ^ (p & 7)) << 4) + (pc & 3) * 4
                row, within = divmod(off, 128)
                assert row == p
                chunk = (within >> 4) ^ (p & 7)
                ch = chunk * 8 + (within & 15) // 2
                seen[p, ch] += 1
                seen[p, ch + 1] += 1
                assert ch == 2 * pc
                banks.add((off // 4) % 32)
            assert len(banks) == 32
    assert (seen == 1).all()


@pytest.mark.parametrize("M,cin,cout", [(147, 24, 72), (266, 64, 136),
                                        (802816, 64, 256),
                                        (12544, 512, 2048), (61, 8, 8)])
def test_b10_dw_chunks_cover_each_pixel_once(M, cin, cout):
    """The dW kernel's splits (`_splits`) cut into chunks of 64 pixels cover
    every pixel exactly once; the tensor cores sum at most three chunks (12
    k-steps) before the register sum takes them."""
    splits, chunk = _splits(M, cin, cout)
    seen = np.zeros(M, np.int64)
    for z in range(splits):
        mb, me = z * chunk, min(M, z * chunk + chunk)
        nst = -(-(me - mb) // DW_STEP) if me > mb else 0
        for k in range(nst):
            lo = mb + k * DW_STEP
            seen[lo:min(me, lo + DW_STEP)] += 1
    assert (seen == 1).all()
    assert math.ceil(M / chunk) == splits


# ---------------------------------------------------------------------------
# the statistics epilogue of the train forwards B9b and B9a
# ---------------------------------------------------------------------------
def b8_tile_pixels(N, Ho, Wo, s):
    """B8's (and B9b's) tiles as its epilogue indexes them: (m, valid), each
    [tiles, 128]: slot p of tile bx is output row t0 + p // TW, column c0 +
    p % TW, valid inside the tile, the batch's rows and the row."""
    TH, TW, _, _, nseg = fwd_geometry(Ho, Wo, s)
    rows_total = N * Ho
    bx = np.arange(nseg * -(-rows_total // TH))
    t0 = (bx // nseg * TH)[:, None]
    c0 = (bx % nseg * TW)[:, None]
    r, c = np.divmod(np.arange(FWD_PIX), TW)
    valid = (r < TH) & (t0 + r < rows_total) & (c0 + c < Wo)
    return np.where(valid, (t0 + r) * Wo + c0 + c, 0), valid


def b7_tile_pixels(M):
    """B7's (and B9a's) pixel tiles: slot p of tile t is pixel 128 t + p,
    valid below M."""
    m = np.arange(-(-M // FWD_PIX))[:, None] * FWD_PIX + np.arange(FWD_PIX)
    valid = m < M
    return np.where(valid, m, 0), valid


def seq_sum(a, axis):
    """fp32 sum along `axis` one term after another, from +0."""
    t = np.zeros(np.delete(a.shape, axis), np.float32)
    for i in range(a.shape[axis]):
        t = t + np.take(a, i, axis=axis)
    return t


def sum_rows(part):
    """`sum_rows_kernel` over [R, C] fp32: group g of G adds rows g, g + G,
    ... into four interleaved sums, then group 0 adds the groups in
    order."""
    R = part.shape[0]
    G = min(max(R // 16, 1), 32)
    groups = []
    for g in range(G):
        t = [np.zeros(part.shape[1], np.float32) for _ in range(4)]
        r = g
        while r + 3 * G < R:
            for i in range(4):
                t[i] = t[i] + part[r + i * G]
            r += 4 * G
        while r < R:
            t[0] = t[0] + part[r]
            r += G
        groups.append((t[0] + t[1]) + (t[2] + t[3]))
    return seq_sum(np.stack(groups), 0)


def emulate_stats(y, m, valid):
    """The statistics epilogue on the stored values y [M, Cout] (bf16 values
    as fp32) over tiles (m, valid): partials [tiles, 2, Cout] in the
    kernel's order (each thread (wm, gq) its pixels wm * 32 + mt * 16 + gq
    + 8 h in (mt, h) order, skipping invalid ones; the xor shuffles over
    gq bits 0, 1, 2; the warps wm in order), then `sum_rows` of them."""
    wm, gq, k = np.ix_(np.arange(4), np.arange(8), np.arange(4))
    p = wm * 32 + (k // 2) * 16 + gq + 8 * (k % 2)            # [4, 8, 4]
    vals = np.where(valid[:, p, None], y[m[:, p]], np.float32(0))
    out = []
    for v in (vals, vals * vals):        # a bf16 value's square is exact
        t = seq_sum(v, 3)                            # [tiles, wm, gq, C]
        for o in (1, 2, 4):
            t = t + t[:, :, np.arange(8) ^ o]
        out.append(seq_sum(t[:, :, 0], 1))
    partial = np.stack(out, 1)                       # [tiles, 2, Cout]
    return partial, sum_rows(partial.reshape(partial.shape[0], -1)) \
        .reshape(2, -1)


def stats_geometry(k, case):
    N, H, W, cin, cout, s, padding = case
    pads = normalize_conv_padding(padding, k, s, in_hw=(H, W))
    (pt, pb), (pl, pr) = pads
    Ho, Wo = (H + pt + pb - k) // s + 1, (W + pl + pr - k) // s + 1
    m, valid = (b8_tile_pixels(N, Ho, Wo, s) if k == 3
                else b7_tile_pixels(N * Ho * Wo))
    return pads, Ho, Wo, m, valid


# B8_CASES for B9b; for B9a ragged pixel tails (M 147, 1064, 266, 25), a
# stride-2 sample and a single tile
B7_CASES = [(3, 7, 7, 24, 72, 1, 0), (3, 7, 7, 24, 72, 2, 0),
            (2, 28, 19, 64, 136, 1, 0), (2, 28, 19, 64, 136, 2, 0),
            (1, 5, 5, 72, 136, 1, 0), (1, 8, 16, 8, 8, 1, 0)]
STATS_CASES = [(3, c) for c in B8_CASES] + [(1, c) for c in B7_CASES]


@pytest.mark.parametrize("k,case", STATS_CASES,
                         ids=[f"k{k}-N{c[0]}-{c[1]}x{c[2]}-{c[4]}-s{c[5]}-"
                              f"p{c[6]}" for k, c in STATS_CASES])
def test_stats_epilogue_counts_each_pixel_once_and_sums_as_fp64(k, case):
    """Over all tiles every valid output pixel of every channel is summed
    exactly once (ragged M tails, image boundaries inside a tile, rows in
    segments, stride 2 with SAME's halo); the fp32 sums in the kernel's
    order agree with fp64 sums of the same bf16 values to 1e-6 of the sum
    of the terms' magnitudes, as does every tile's partial; the tiles are
    the rows `conv_train_partial_rows` allocates."""
    N, H, W, cin, cout, s, _ = case
    pads, Ho, Wo, m, valid = stats_geometry(k, case)
    M = N * Ho * Wo
    assert m.shape[0] == conv_train_partial_rows(k, torch.bfloat16, N, Ho,
                                                 Wo, s)
    seen = np.bincount(m[valid], minlength=M)
    assert seen.shape == (M,) and (seen == 1).all()
    rng = np.random.RandomState(1)
    x = rng.standard_normal((N, H, W, cin))
    w = rng.standard_normal((k, k, cin, cout)) * 0.1
    y = torch.from_numpy(conv_fp64(x, w, s, pads).reshape(M, cout)) \
        .to(torch.bfloat16).float().numpy()
    partial, sums = emulate_stats(y, m, valid)
    y64 = y.astype(np.float64)
    terms = (y64, y64 * y64)
    for i, t in enumerate(terms):
        mag = np.abs(t).sum(0)
        assert (np.abs(sums[i] - t.sum(0)) <= 1e-6 * mag).all()
        tile_terms = np.where(valid[..., None], t[m], 0.0)
        assert (np.abs(partial[:, i] - tile_terms.sum(1))
                <= 1e-6 * np.abs(tile_terms).sum(1)).all()


def test_stats_partial_rows_at_the_sweep_shapes():
    """At bench_ops.py's nine sweep shapes (batch 256, SAME) the bf16 train
    forwards write one partial row per tile, each valid pixel once: B7's
    128-pixel tiles for the 1x1, B8's for the 3x3, 7168 rows at c2's 3x3
    (112-pixel tiles) against the 6272 of ceil(M / 128), which the f32
    kernels keep."""
    sweep = [(56, 64, 256, 1, 1), (56, 64, 64, 3, 1), (56, 128, 128, 3, 2),
             (28, 128, 128, 3, 1), (28, 256, 256, 3, 2), (14, 256, 256, 3, 1),
             (14, 512, 512, 3, 2), (7, 512, 512, 3, 1), (7, 512, 2048, 1, 1)]
    N = 256
    for hw, _, _, k, s in sweep:
        Ho = Wo = -(-hw // s)
        M = N * Ho * Wo
        m, valid = (b8_tile_pixels(N, Ho, Wo, s) if k == 3
                    else b7_tile_pixels(M))
        assert (np.bincount(m[valid], minlength=M) == 1).all()
        assert m.shape[0] == conv_train_partial_rows(k, torch.bfloat16, N,
                                                     Ho, Wo, s)
        assert conv_train_partial_rows(k, torch.float32, N, Ho, Wo, s) == \
            -(-M // 128)
    assert conv_train_partial_rows(3, torch.bfloat16, N, 56, 56, 1) == 7168
