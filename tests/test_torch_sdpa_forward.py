"""The flash forward B6 of the PyTorch port against the JAX package, on the
CPU.

`sdpa_forward_plain` (what the kernel's wrapper runs on a CPU tensor) is
held against the JAX Pallas kernel `_sdpa_fwd_kernel` itself, run in
interpret mode through `pallas_sdpa_forward`, and, at the shapes only the
port's library route hands it (Sq != Skv, head dims 128 to 256), against
the dense `_xla_attention`. The port's `pallas_sdpa_forward` keeps JAX's
block assert. `flash_attention`'s library route is held to JAX's output,
and its CPU routing is counted: B6's plain version when no gradient is
needed, the dense route (counted) when one is; GPT and BERT shapes keep
their kernels' routes. Same seeded numpy inputs to both packages; fp32;
within 1e-5 (fp32 sums in another order).
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as tfa

# the module, not the function that paddle_tpu.ops.pallas re-exports
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

ATOL = 1e-5


def _rand(seed, *shapes):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*s).astype(np.float32) for s in shapes)


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_sdpa_forward_matches_jax_interpret_kernel(causal):
    """B1 S256 H2 D64, blocks of 128: the port's `pallas_sdpa_forward` (the
    plain version here, no launch) and `sdpa_forward_plain` in `[BH, S, D]`
    against JAX's `pallas_sdpa_forward(interpret=True)`."""
    B, S, H, D = 1, 256, 2, 64
    q, k, v = _rand(0 if causal else 1, *[(B, S, H, D)] * 3)
    want = np.asarray(jfa.pallas_sdpa_forward(q, k, v, causal=causal,
                                              block_q=128, block_k=128,
                                              interpret=True))
    launches = tfa.sdpa_forward.launches
    plain = tfa.sdpa_forward.plain_calls
    got = tfa.pallas_sdpa_forward(*_t(q, k, v), causal=causal, block_q=128,
                                  block_k=128, interpret=True)
    assert (tfa.sdpa_forward.launches, tfa.sdpa_forward.plain_calls) == (
        launches, plain + 1)
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)

    def bh(x):
        return torch.from_numpy(x).transpose(1, 2).reshape(B * H, S, D)

    o = tfa.sdpa_forward_plain(bh(q), bh(k), bh(v), 1.0 / math.sqrt(D),
                               causal)
    np.testing.assert_allclose(
        o.reshape(B, H, S, D).transpose(1, 2).numpy(), want, atol=ATOL,
        rtol=0)


@pytest.mark.parametrize("Sq,Skv,D,causal", [
    (128, 384, 64, False),     # cross-attention, as the decoder's
    (256, 256, 128, True),
    (128, 256, 192, False),
    (128, 128, 256, True),
])
def test_plain_sdpa_forward_matches_jax_dense_attention(Sq, Skv, D, causal):
    """Shapes the port's library route gives B6 where a TPU runs jax's
    library kernel: `sdpa_forward` (its plain version) against JAX's
    `_xla_attention` in `[B, H, S, D]`, fp32 (where the dense route's cast
    of the probabilities to q's dtype is exact)."""
    B, H = 2, 2
    q, k, v = _rand(Sq + Skv + D, (B, H, Sq, D), (B, H, Skv, D),
                    (B, H, Skv, D))
    scale = 1.0 / math.sqrt(D)
    want = np.asarray(jfa._xla_attention(q, k, v, causal, scale))
    got = tfa.sdpa_forward(*(x.reshape(B * H, -1, D) for x in _t(q, k, v)),
                           causal=causal)
    np.testing.assert_allclose(got.reshape(B, H, Sq, D).numpy(), want,
                               atol=ATOL, rtol=0)


def test_pallas_sdpa_forward_keeps_the_block_assert():
    """S must be a multiple of each block after `min(block, S)`, in the
    port as in JAX: S 384 with blocks of 256 fails; S 128 cuts the blocks
    to 128 and runs."""
    q, = _rand(5, (1, 384, 1, 64))
    with pytest.raises(AssertionError):
        jfa.pallas_sdpa_forward(q, q, q, interpret=True)
    with pytest.raises(AssertionError):
        tfa.pallas_sdpa_forward(*_t(q, q, q))
    with pytest.raises(AssertionError):
        tfa.pallas_sdpa_forward(*_t(q, q, q), block_q=128, block_k=256)
    small, = _rand(6, (1, 128, 1, 64))
    want = np.asarray(jfa.pallas_sdpa_forward(small, small, small,
                                              interpret=True))
    got = tfa.pallas_sdpa_forward(*_t(small, small, small))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_sdpa_forward_refuses_causal_cross_attention():
    """Causal B6 is defined at Sq == Skv only (the TPU kernel's shapes),
    on every device."""
    q, k = _t(*_rand(7, (2, 128, 64), (2, 256, 64)))
    with pytest.raises(ValueError, match="Sq == Skv"):
        tfa.sdpa_forward(q, k, k, causal=True)


def _counts():
    return (tfa.sdpa_forward.plain_calls,
            tfa.shortseq_attention_fwd.plain_calls,
            tfa.causal_attention_fwd.plain_calls,
            tfa.flash_attention.dense_calls)


@pytest.mark.parametrize("shape,causal,moved", [
    # library shapes: B6 (its plain version here)
    (((1, 1024, 2, 64), (1, 1024, 2, 64)), False, (1, 0, 0, 0)),
    (((2, 128, 2, 64), (2, 384, 2, 64)), False, (1, 0, 0, 0)),
    (((1, 128, 1, 192), (1, 128, 1, 192)), True, (1, 0, 0, 0)),
    (((1, 128, 1, 256), (1, 128, 1, 256)), False, (1, 0, 0, 0)),
    (((1, 128, 1, 320), (1, 128, 1, 320)), False, (1, 0, 0, 0)),
    # GPT and BERT shapes keep their kernels' routes
    (((1, 128, 2, 64), (1, 128, 2, 64)), False, (0, 1, 0, 0)),
    (((1, 1024, 2, 64), (1, 1024, 2, 64)), True, (0, 0, 1, 0)),
    (((1, 256, 2, 128), (1, 256, 2, 128)), True, (0, 0, 1, 0)),
    # no kernel takes these: dense
    (((2, 128, 2, 64), (2, 384, 2, 64)), True, (0, 0, 0, 1)),
    (((1, 96, 2, 64), (1, 96, 2, 64)), False, (0, 0, 0, 1)),
])
def test_library_route_routes_like_jax_without_a_gradient(shape, causal,
                                                          moved):
    """With no gradient needed, each shape takes its route, counted, and
    the output matches JAX's `flash_attention` (dense on the CPU)."""
    qs, kvs = shape
    q, k, v = _rand(sum(qs) + sum(kvs), qs, kvs, kvs)
    want = np.asarray(jfa.flash_attention(q, k, v, causal=causal))
    before = _counts()
    with torch.no_grad():
        got = tfa.flash_attention(*_t(q, k, v), causal=causal)
    assert tuple(a - b for a, b in zip(_counts(), before)) == moved
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape,causal", [
    (((2, 128, 2, 64), (2, 384, 2, 64)), False),
    (((1, 128, 1, 192), (1, 128, 1, 192)), True),
])
def test_library_route_with_a_gradient_is_dense_on_the_cpu(shape, causal):
    """When an input requires grad under grad mode, a library shape is
    computed densely on the CPU (counted), as JAX computes it there; its
    gradients match `jax.grad`. Grad mode off runs B6's plain version on
    the same inputs."""
    qs, kvs = shape
    q, k, v = _rand(3 * sum(qs), qs, kvs, kvs)
    do, = _rand(4, qs)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    before = _counts()
    got = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (0, 0, 0, 1)
    want = np.asarray(jfa.flash_attention(q, k, v, causal=causal))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=0)
    jgrads = jax.grad(lambda a, b, c: jnp.sum(
        jfa.flash_attention(a, b, c, causal=causal) * do),
        argnums=(0, 1, 2))(q, k, v)
    got.backward(torch.from_numpy(do))
    for t, j in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-4,
                                   rtol=0)
    with torch.no_grad():
        tfa.flash_attention(tq, tk, tv, causal=causal)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 0, 0, 1)
