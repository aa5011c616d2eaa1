"""The int8-weight linear's launch plan and its shard invariance, on the CPU.

The bf16 kernel (`csrc/int8_linear.cu`) splits K over the CTAs of a
thread-block cluster. `ops.int8_linear._plan(M, N, K)` is its launch plan
and `_shares(K, split)` below the cut of K the kernel makes (`k_share`).
The split must depend on (M, K) alone: a tensor-parallel shard launches the
same K over N / mp rows of codes (`models/gpt.py`), and a column's sum
order, and so its bits, must be the whole launch's. This file pins that on
the plan, the cut of K and the plain version; the kernel's own columns are
held to the whole launch's on the card (`tests/test_torch_kernels_cuda.py`,
chip_smoke.py phase int8_linear). Imports nothing of JAX.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.int8_linear import _plan, int8_linear_plain
from paddle_tpu_torch.quantization import quantize_absmax
from paddle_tpu_torch.utils.cpp_extension import CSRC

# GPT-1.3B's four projections (K, N), as chip_smoke.py's W8_SHAPES
PROJECTIONS = {"qkv": (2048, 6144), "out": (2048, 2048),
               "fc1": (2048, 8192), "fc2": (8192, 2048)}
ROWS = (1, 8, 9, 16, 17, 40, 128)


def _shares(K, split):
    """`[(k_begin, k_end)]` of each rank of a split, as the kernel's
    `k_share` cuts K: ceil(K / split) rounded up to 16 a rank, the last
    one to K."""
    kc = (-(-K // split) + 15) // 16 * 16
    return [(min(K, r * kc), min(K, (r + 1) * kc)) for r in range(split)]


@pytest.mark.parametrize("name", sorted(PROJECTIONS))
@pytest.mark.parametrize("M", ROWS)
def test_split_is_the_same_for_every_shard(name, M):
    """The whole launch and its N / 2 and N / 4 shards split K alike, in
    a cluster of at most 8; the tile's rows follow M alone."""
    K, N = PROJECTIONS[name]
    plans = [_plan(M, N // mp, K) for mp in (1, 2, 4)]
    assert len({p[0] for p in plans}) == 1
    assert len({p[2] for p in plans}) == 1
    split, bn, bm = plans[0]
    assert 1 <= split <= 8
    assert bm == (8 if M <= 8 else 16 if M <= 16 else 64)
    assert all(p[1] in ((16, 32, 64) if bm < 64 else (64,)) for p in plans)


@pytest.mark.parametrize("K", [16, 48, 1040, 1536, 2048, 2064, 4096, 8192,
                               16400])
@pytest.mark.parametrize("M", [8, 40])
def test_shares_cover_k_in_multiples_of_16(K, M):
    """Each rank's share of K starts and ends on a multiple of 16, none is
    empty, and together they are K exactly, in rank order."""
    split = _plan(M, 64, K)[0]
    shares = _shares(K, split)
    assert len(shares) == split <= 8
    assert shares[0][0] == 0 and shares[-1][1] == K
    for (b0, e0), (b1, _) in zip(shares, shares[1:]):
        assert e0 == b1
    for b, e in shares:
        assert b % 16 == 0 and e % 16 == 0 and e > b


def test_plan_at_the_decode_step():
    """About 1024 of K a CTA, and BN narrowed until two CTAs an SM: 256-512
    CTAs at each of GPT-1.3B's projections at M 8."""
    plans = {n: _plan(8, N, K) for n, (K, N) in PROJECTIONS.items()}
    assert plans == {"qkv": (2, 32, 8), "out": (2, 16, 8),
                     "fc1": (2, 32, 8), "fc2": (8, 32, 8)}
    for n, (split, bn, _) in plans.items():
        assert 256 <= -(-PROJECTIONS[n][1] // bn) * split <= 512


def test_shares_are_the_kernels_cut():
    """`_shares` above and the kernel's `k_share` cut K by one formula."""
    text = (Path(CSRC) / "int8_linear.cu").read_text()
    assert re.search(
        r"return \(\(K \+ split - 1\) / split \+ 15\) / 16 \* 16;", text)
    for K, split in ((2048, 2), (8192, 8), (1536, 2), (16400, 8)):
        kc = ((K + split - 1) // split + 15) // 16 * 16
        assert _shares(K, split)[0] == (0, kc)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,N,K", [(8, 96, 64), (40, 256, 512)])
def test_plain_shard_columns_are_the_whole_columns(dtype, M, N, K):
    """The plain version over a shard's codes, scales and bias gives, bit
    for bit, the whole launch's columns of that shard."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)
                         * 0.02).to(dtype)
    q, s = quantize_absmax(w, axis=0)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(dtype)
    b = torch.from_numpy(rng.standard_normal(N).astype(np.float32)
                         * 0.1).to(dtype)
    whole = int8_linear_plain(x, q, s, b)
    for mp in (2, 4):
        n = N // mp
        for r in range(mp):
            cols = slice(r * n, (r + 1) * n)
            got = int8_linear_plain(x, q[cols].contiguous(),
                                    s[cols].contiguous(),
                                    b[cols].contiguous())
            assert torch.equal(got, whole[:, cols])
