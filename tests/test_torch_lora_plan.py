"""The batched LoRA kernel's launch plan and its sum order, on the CPU.

The kernel (`csrc/lora.cu`) splits each slot's shrink over the CTAs of a
thread-block cluster. `ops.lora._plan(in_dim, R, S)` is its launch plan:
the cluster size, the rows of a slot a tile and the shrink's segments.
`_shares` below is the cut of in_dim the kernel makes (`p.ks`). The plan
must depend on (in_dim, R, rows a slot) alone: a tensor-parallel shard
launches the same x and A over out / mp columns of B (`models/gpt.py`),
and its columns must be the whole launch's bits; a bf16 and an f32 launch
must sum in one order. `_emulate_delta` repeats the kernel's order in
numpy (each chunk's 8 products fused into the sum in order, the chunks of
a segment in order, the segments by a xor butterfly, the ranks in rank
order, then the R ranks of the expand in order) and holds it to the fp64
delta within chip_smoke.py's LORA_DELTA_TOL at GPT-1.3B's widths. The
kernel itself is held to its plain version on the card
(`tests/test_torch_kernels_cuda.py`, chip_smoke.py phase lora). Imports
nothing of JAX.
"""
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.lora import _plan
from paddle_tpu_torch.utils.cpp_extension import CSRC

# GPT-1.3B's LoRA sites (in, out), as chip_smoke.py's LORA_SITES_1P3B
SITES = {"qkv": (2048, 6144), "out": (2048, 2048), "fc1": (2048, 8192),
         "fc2": (8192, 2048)}
# rows a slot: decode, verify at K=4, a ragged tail, the prefill chunk, a
# bucketed prompt
ROWS = (1, 5, 17, 128, 300)
# chip_smoke.py's bar on the fp32 delta, max |kernel - plain| / max |plain|
LORA_DELTA_TOL = 2e-6


def _shares(in_dim, cluster):
    """`[(begin, end)]` of each rank, as the kernel cuts in_dim: ceil(in /
    C) rounded up to whole chunks of 8 a rank, the last ones to in_dim."""
    ks = (-(-in_dim // cluster) + 7) // 8 * 8
    return [(min(in_dim, r * ks), min(in_dim, (r + 1) * ks))
            for r in range(cluster)]


def test_plan_takes_no_out_dim():
    """The plan's inputs are in_dim, the rank and the rows a slot: no
    output width, no dtype."""
    assert list(inspect.signature(_plan.__wrapped__).parameters) == \
        ["in_dim", "R", "S"]


@pytest.mark.parametrize("site", sorted(SITES))
@pytest.mark.parametrize("S", ROWS)
@pytest.mark.parametrize("R", [1, 4, 16, 64])
def test_plan_is_the_same_for_every_shard(site, S, R):
    """Every mp 1, 2, 4 shard of a GPT-1.3B site launches the same x and A
    (in_dim, R, S) and so takes the same plan: a cluster of at most 8,
    all a slot's rows up to 16 a tile, a power of two of segments whose
    threads fit the CTA."""
    n_in, n_out = SITES[site]
    plans = {_plan(n_in, R, S) for mp in (1, 2, 4) if n_out % mp == 0}
    assert len(plans) == 1
    cluster, tile, seg = plans.pop()
    assert 1 <= cluster <= 8 and cluster & (cluster - 1) == 0
    assert tile == min(S, 16)
    tiles = -(-tile // 4) * -(-R // 4)
    assert 1 <= seg <= 32 and seg & (seg - 1) == 0 and seg * tiles <= 256


def test_plan_at_the_serving_shapes():
    """8 CTAs (a portable cluster) share GPT-1.3B's 2048 and 8192 inputs;
    the decode and verify steps run one tile a slot, the 128-row prefill
    chunk eight."""
    assert {n: _plan(n_in, 16, 1) for n, (n_in, _) in SITES.items()} == \
        {n: (8, 1, 32) for n in SITES}
    assert _plan(2048, 16, 5) == (8, 5, 32)
    assert _plan(2048, 16, 128) == (8, 16, 16)
    assert _plan(8192, 64, 128) == (8, 16, 4)
    assert _plan(48, 4, 3)[0] == 1 and _plan(512, 16, 1)[0] == 4


@pytest.mark.parametrize("in_dim", [1, 7, 8, 40, 48, 96, 255, 1000, 1030,
                                    2048, 2050, 4100, 8192, 16383])
def test_shares_are_whole_chunks_but_the_last(in_dim):
    """Each rank's share starts on a chunk of 8 and is whole chunks, but
    for the last one that holds inputs; together they are in_dim, in rank
    order, at least 128 inputs a rank where the cluster is above 1."""
    cluster = _plan(in_dim, 16, 1)[0]
    shares = _shares(in_dim, cluster)
    assert len(shares) == cluster <= 8
    assert shares[0][0] == 0 and shares[-1][1] == in_dim
    for (b0, e0), (b1, _) in zip(shares, shares[1:]):
        assert e0 == b1
    held = [(b, e) for b, e in shares if e > b]
    for b, e in held:
        assert b % 8 == 0
    for b, e in held[:-1]:
        assert (e - b) % 8 == 0
    if cluster > 1:
        assert all(e - b >= 128 for b, e in held[:-1])


def test_shares_are_the_kernels_cut():
    """`_shares` above and the kernel's `p.ks`, its columns' `p.cs` and its
    ranks' begin cut by one formula."""
    text = (Path(CSRC) / "lora.cu").read_text()
    assert "p.ks = round_up((in_dim + cluster - 1) / cluster, kChunk);" \
        in text
    assert "p.cs = round_up((out_dim + cluster - 1) / cluster, kChunk);" \
        in text
    assert re.search(r"const int k0 = min\(in_dim, static_cast<int>\(rank\)"
                     r" \* p\.ks\);", text)
    assert "constexpr int kChunk = 8;" in text


def _fma(a, b, c):
    """fmaf on float32 arrays: the exact product of two bf16 values (16
    significant bits) plus a float32 is exact in float64 over these
    ranges, so one rounding to float32 is the fused result."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _emulate_xr(x, a, cluster, seg):
    """xr [rows, R] in the kernel's order: rank c's share in chunks of 8,
    chunk j to segment j % seg (8 fused products in order a chunk, the
    chunks in order), the segments by a xor butterfly, then the ranks'
    partials added in rank order, all in float32."""
    rows, n_in = x.shape
    R = a.shape[0]
    total = None
    for b, e in _shares(n_in, cluster):
        nch = -(-(e - b) // 8)
        width = nch * 8
        xs = np.zeros((rows, width), np.float32)
        as_ = np.zeros((R, width), np.float32)
        xs[:, :e - b] = x[:, b:e]
        as_[:, :e - b] = a[:, b:e]
        # acc[segment][row][rank]
        acc = np.zeros((seg, rows, R), np.float32)
        for j0 in range(0, nch, seg):
            js = [j for j in range(j0, min(nch, j0 + seg))]
            for el in range(8):
                for j in js:
                    col = j * 8 + el
                    acc[j % seg] = _fma(xs[:, col][:, None],
                                        as_[:, col][None, :], acc[j % seg])
        off = seg // 2
        while off:
            acc = (acc + acc[np.arange(seg) ^ off]).astype(np.float32)
            off //= 2
        part = acc[0]
        total = part if total is None else (total + part).astype(np.float32)
    return total


def _emulate_delta(x, a, b, s, cluster, seg):
    """The fp32 delta: xr in the kernel's order, then each column's R
    ranks fused in order, then the scaling."""
    xr = _emulate_xr(x, a, cluster, seg)
    d = np.zeros((x.shape[0], b.shape[1]), np.float32)
    for r in range(a.shape[0]):
        d = _fma(xr[:, r][:, None], b[r][None, :], d)
    return (d * np.float32(s)).astype(np.float32)


@pytest.mark.parametrize("site,S", [("fc2", 1), ("fc2", 5), ("fc1", 5),
                                    ("qkv", 1), ("fc2", 128)])
def test_emulated_order_holds_the_delta_bar(site, S):
    """The kernel's sum order, emulated over bf16 values at GPT-1.3B's
    widths and rank 16, stays within LORA_DELTA_TOL of max |delta| from the
    fp64 delta; the whole launch's columns and a shard's are one order."""
    n_in, n_out = SITES[site]
    n_out = min(n_out, 512)             # the expand's columns are alike
    rng = np.random.default_rng(11)
    bf = lambda v: torch.from_numpy(v.astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    R = 16
    x = bf(rng.standard_normal((S, n_in)))
    a = bf(rng.standard_normal((R, n_in)) / np.sqrt(n_in))
    b = bf(rng.standard_normal((R, n_out)) * 0.1)
    s = 1.25
    cluster, _, seg = _plan(n_in, R, S)
    got = _emulate_delta(x, a, b, s, cluster, seg)
    ref = (x.astype(np.float64) @ a.T.astype(np.float64)
           @ b.astype(np.float64)) * s
    err = np.abs(got - ref).max()
    assert err <= LORA_DELTA_TOL * np.abs(ref).max()
    half = _emulate_delta(x, a, b[:, n_out // 2:], s, cluster, seg)
    assert np.array_equal(half, got[:, n_out // 2:])
