"""Causal attention of the PyTorch port against the JAX package.

The plain versions of the forward and backward kernels (what the CUDA
kernels' wrappers run on a CPU tensor) are held against the JAX Pallas
kernels themselves, run in interpret mode, and against the dense
`_xla_attention` (and `jax.grad` through it) at ragged lengths; the
autograd function against `jax.grad` through JAX's
`chunked_causal_attention`; the dense routes (causal Sq != Skv, a mask with
`is_causal`) against JAX's. Same seeded numpy inputs to both; fp32; within
1e-5.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.nn_ops import scaled_dot_product_attention as j_sdpa
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops.nn_ops import (attention_with_generator,
                                         scaled_dot_product_attention)

# the module, not the function that paddle_tpu.ops.pallas re-exports
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")


def _qkv(rng, *shape):
    return tuple(rng.randn(*shape).astype(np.float32) for _ in range(3))


def test_plain_causal_forward_matches_jax_interpret_kernel():
    """B1 H2 S256 D64: O and LSE against `_causal_call_fwd` (the TPU
    kernel's LSE is [BH, 8, S], eight identical rows), and the paddle
    layout entry against `chunked_causal_attention(interpret=True)`."""
    rng = np.random.RandomState(0)
    B, S, H, D = 1, 256, 2, 64
    scale = 1.0 / math.sqrt(D)
    q, k, v = _qkv(rng, B * H, S, D)
    jo, jl = jfa._causal_call_fwd(q, k, v, scale,
                                  jfa._causal_bq(S, D, 4), interpret=True)
    launches = tfa.causal_attention_fwd.launches
    o, lse = tfa.causal_attention_fwd(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), scale)
    assert tfa.causal_attention_fwd.launches == launches
    assert lse.shape == (B * H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[:, 0], atol=1e-5,
                               rtol=0)

    qb, kb, vb = _qkv(rng, B, S, H, D)
    want = jfa.chunked_causal_attention(qb, kb, vb, interpret=True)
    got = tfa.chunked_causal_attention(torch.from_numpy(qb),
                                       torch.from_numpy(kb),
                                       torch.from_numpy(vb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("S", [1, 77, 130])
def test_plain_causal_forward_matches_xla_attention_at_ragged_s(S):
    rng = np.random.RandomState(S)
    BH, D = 3, 64
    scale = 1.0 / math.sqrt(D)
    q, k, v = _qkv(rng, BH, S, D)
    want = jfa._xla_attention(q[None], k[None], v[None], True, scale)[0]
    o, lse = tfa.causal_attention_fwd(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    logits = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k) * scale
    logits = np.where(np.tril(np.ones((S, S), bool)), logits, -np.inf)
    m = logits.max(-1)
    want_lse = m + np.log(np.exp(logits - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal,Sq,Skv", [(True, 5, 9), (False, 7, 7),
                                           (False, 4, 11)])
def test_flash_attention_without_kernel_raises(causal, Sq, Skv):
    """Shapes without a kernel (here D 16, which no TPU kernel takes) are
    computed densely, as JAX computes them on every device, through
    `flash_attention` and the mask-free `scaled_dot_product_attention`
    alike, each counted in `flash_attention.dense_calls`: causal
    Sq != Skv, and non-causal shapes whether Sq == Skv or not. The causal
    Sq == Skv case at the same widths matches JAX."""
    rng = np.random.RandomState(Sq * Skv)
    B, H, D = 2, 3, 16
    q = torch.from_numpy(rng.randn(B, Sq, H, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, Skv, H, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, Skv, H, D).astype(np.float32))
    want = np.asarray(jfa.flash_attention(q.numpy(), k.numpy(), v.numpy(),
                                          causal=causal))
    dense = tfa.flash_attention.dense_calls
    for got in (tfa.flash_attention(q, k, v, causal=causal),
                scaled_dot_product_attention(q, k, v, is_causal=causal)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert tfa.flash_attention.dense_calls == dense + 2
    want = jfa.flash_attention(q.numpy(), q.numpy(), q.numpy(), causal=True)
    got = tfa.flash_attention(q, q, q, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("Sq,Skv", [(5, 9), (1, 7), (3, 4)])
def test_causal_flash_attention_sq_ne_skv_is_dense_like_jax(Sq, Skv):
    """Causal with Sq != Skv has no TPU kernel: JAX computes it densely,
    bottom-right aligned, on every device, and so does the port (counted
    in `flash_attention.dense_calls`), with gradients through autograd."""
    rng = np.random.RandomState(Sq * 31 + Skv)
    B, H, D = 2, 3, 16
    q = rng.randn(B, Sq, H, D).astype(np.float32)
    k = rng.randn(B, Skv, H, D).astype(np.float32)
    v = rng.randn(B, Skv, H, D).astype(np.float32)
    do = rng.randn(B, Sq, H, D).astype(np.float32)
    want = jfa.flash_attention(q, k, v, causal=True)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    calls = tfa.flash_attention.dense_calls
    got = tfa.flash_attention(tq, tk, tv, causal=True)
    assert tfa.flash_attention.dense_calls == calls + 1
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    jgrads = jax.grad(lambda a, b, c: jnp.sum(
        jfa.flash_attention(a, b, c, causal=True) * do), (0, 1, 2))(q, k, v)
    tgrads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    for jg, tg in zip(jgrads, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5,
                                   rtol=0)


def test_masked_sdpa_with_is_causal_raises():
    """A mask together with `is_causal` no longer raises: it takes JAX's
    dense branch, where the bottom-right causal mask and the additive mask
    both apply, and matches JAX (Sq == Skv and Sq < Skv)."""
    rng = np.random.RandomState(4)
    B, H, D = 2, 2, 16
    for Sq, Skv in ((4, 4), (1, 6)):
        q = rng.randn(B, Sq, H, D).astype(np.float32)
        k = rng.randn(B, Skv, H, D).astype(np.float32)
        v = rng.randn(B, Skv, H, D).astype(np.float32)
        mask = np.where(rng.rand(B, 1, Sq, Skv) < 0.3, -1e30, 0.0).astype(
            np.float32)
        mask[..., -1] = 0.0                # every row keeps a key
        want = j_sdpa(q, k, v, attn_mask=mask, is_causal=True)
        got = scaled_dot_product_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            attn_mask=torch.from_numpy(mask), is_causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want._array),
                                   atol=1e-5, rtol=0)


def test_sdpa_dropout_takes_the_dense_branch_and_drops_the_output():
    """dropout_p > 0 in training: the dense branch, then dropout on the
    output (kept values are the dense output / keep, exactly). dropout_p
    > 0 not in training: the dense branch, nothing dropped, as JAX routes
    it (the flash route only at dropout_p == 0.0). dropout_p 0: the kernel
    route (head dim 64: the causal kernel's; other head dims are dense, as
    in JAX). The models' entry, `attention_with_generator`, draws the mask
    from their generator; no generator raises."""
    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rng.randn(2, 8, 2, 64).astype(np.float32))
               for _ in range(3))
    dense = tfa.dense_attention(q, k, v, True)
    g = torch.Generator().manual_seed(3)
    fwd = tfa.causal_attention_fwd.plain_calls
    out = attention_with_generator(q, k, v, dropout_p=0.25,
                                       is_causal=True, generator=g)
    assert tfa.causal_attention_fwd.plain_calls == fwd
    kept = out != 0
    assert 0 < int(kept.sum()) < out.numel()
    torch.testing.assert_close(out[kept], (dense / 0.75)[kept], rtol=0,
                               atol=0)
    for p, training in ((0.25, False), (0.0, True)):
        got = attention_with_generator(q, k, v, dropout_p=p,
                                           is_causal=True, training=training,
                                           generator=g)
        if p > 0.0:
            assert tfa.causal_attention_fwd.plain_calls == fwd
            torch.testing.assert_close(got, dense, rtol=0, atol=0)
            continue
        assert tfa.causal_attention_fwd.plain_calls == fwd + 1
        torch.testing.assert_close(got, tfa.chunked_causal_attention(
            q, k, v), rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        attention_with_generator(q, k, v, dropout_p=0.25, is_causal=True)


def test_plain_causal_backward_matches_jax_interpret_kernel():
    """B1 H2 S256 D64: dq, dk, dv of the plain backward against
    `_causal_call_bwd` (the TPU kernel, interpreted) on the same q, k, v,
    dO and the JAX forward's O and LSE (the port's LSE is row 0 of the TPU
    kernel's [BH, 8, S])."""
    rng = np.random.RandomState(1)
    BH, S, D = 2, 256, 64
    scale = 1.0 / math.sqrt(D)
    q, k, v = _qkv(rng, BH, S, D)
    do = rng.randn(BH, S, D).astype(np.float32)
    bq = jfa._causal_bq(S, D, 4)
    jo, jl = jfa._causal_call_fwd(q, k, v, scale, bq, interpret=True)
    want = jfa._causal_call_bwd(q, k, v, jo, do, jl, scale, bq,
                                interpret=True)
    launches = tfa.causal_attention_bwd.launches
    plain = tfa.causal_attention_bwd.plain_calls
    got = tfa.causal_attention_bwd(*(torch.tensor(np.asarray(x)) for x in
                                     (q, k, v, jo, do, np.asarray(jl)[:, 0])),
                                   scale)
    assert tfa.causal_attention_bwd.launches == launches
    assert tfa.causal_attention_bwd.plain_calls == plain + 1
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("S", [1, 77, 130])
def test_plain_causal_backward_matches_grad_of_xla_attention(S):
    """Ragged S (the TPU kernel needs S % 128 == 0, the port does not):
    the plain backward from the port's own forward against `jax.grad` of
    the dense `_xla_attention`."""
    rng = np.random.RandomState(100 + S)
    BH, D = 3, 64
    scale = 1.0 / math.sqrt(D)
    q, k, v = _qkv(rng, BH, S, D)
    do = rng.randn(BH, S, D).astype(np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(jfa._xla_attention(
        a[None], b[None], c[None], True, scale)[0] * do), (0, 1, 2))(q, k, v)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tfa.causal_attention_fwd(tq, tk, tv, scale)
    got = tfa.causal_attention_bwd(tq, tk, tv, o, tdo, lse, scale)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_causal_attention_function_grads_match_jax_chunked():
    """Gradients through `chunked_causal_attention` (the autograd function
    whose backward is the backward kernel's wrapper) against `jax.grad`
    through JAX's `chunked_causal_attention(interpret=True)`, B1 S256 H2
    D64 paddle layout; under `torch.no_grad()` the forward alone runs."""
    rng = np.random.RandomState(2)
    B, S, H, D = 1, 256, 2, 64
    q, k, v = _qkv(rng, B, S, H, D)
    do = rng.randn(B, S, H, D).astype(np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(jfa.chunked_causal_attention(
        a, b, c, interpret=True) * do), (0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    bwd = tfa.causal_attention_bwd.plain_calls
    out = tfa.chunked_causal_attention(tq, tk, tv)
    out.backward(torch.from_numpy(do))
    assert tfa.causal_attention_bwd.plain_calls == bwd + 1
    for w, t in zip(want, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    with torch.no_grad():
        again = tfa.chunked_causal_attention(tq, tk, tv)
    assert again.grad_fn is None
    torch.testing.assert_close(again, out.detach(), rtol=0, atol=0)


def test_masked_sdpa_matches_jax():
    """The fixed-cache decode attention of generate(): an additive -1e30
    mask over a cache buffer."""
    rng = np.random.RandomState(4)
    B, T, H, D = 2, 12, 2, 16
    q = rng.randn(B, 1, H, D).astype(np.float32)
    k = rng.randn(B, T, H, D).astype(np.float32)
    v = rng.randn(B, T, H, D).astype(np.float32)
    mask = np.where(np.arange(T) <= 6, 0.0, -1e30).astype(
        np.float32).reshape(1, 1, 1, T)
    want = j_sdpa(q, k, v, attn_mask=mask)
    got = scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._array),
                               atol=1e-5, rtol=0)


def test_causal_flash_attention_routes_like_jax():
    """Causal Sq == Skv in JAX's order (ROADMAP Queue C 8): head dims 64
    and 128 take `chunked_causal_attention` (its plain version here); a
    library shape (S 128, D 192) with a gradient needed, as here, takes
    `_LibraryAttention` (B6 with its LSE and the library backward, their
    plain versions here), with or without one B6; every other head dim
    (16, 32, 80) is dense, counted in `flash_attention.dense_calls`, as
    JAX computes them off a TPU. Outputs and gradients match JAX's
    `flash_attention` and `jax.grad` of it."""
    cases = [(64, 64, 1), (32, 128, 1), (128, 192, 0), (48, 16, 0),
             (40, 32, 0), (24, 80, 0)]
    for S, D, to_kernel in cases:
        rng = np.random.RandomState(S + D)
        q, k, v = _qkv(rng, 1, S, 2, D)
        do = rng.randn(1, S, 2, D).astype(np.float32)
        want = jfa.flash_attention(q, k, v, causal=True)
        jgrads = jax.grad(lambda a, b, c: jnp.sum(
            jfa.flash_attention(a, b, c, causal=True) * do),
            argnums=(0, 1, 2))(q, k, v)
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        dense = tfa.flash_attention.dense_calls
        plain = tfa.causal_attention_fwd.plain_calls
        lib = tfa.sdpa_forward.plain_calls, tfa.sdpa_backward.plain_calls
        got = tfa.flash_attention(tq, tk, tv, causal=True)
        to_lib = int(D == 192)
        assert tfa.causal_attention_fwd.plain_calls - plain == to_kernel
        assert tfa.sdpa_forward.plain_calls - lib[0] == to_lib
        assert tfa.flash_attention.dense_calls - dense == \
            1 - to_kernel - to_lib
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0, err_msg=str((S, D)))
        got.backward(torch.from_numpy(do))
        assert tfa.sdpa_backward.plain_calls - lib[1] == to_lib
        for t, j in zip((tq, tk, tv), jgrads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                       atol=1e-4, rtol=0,
                                       err_msg=str((S, D)))
        sdpa = tfa.sdpa_forward.plain_calls
        with torch.no_grad():
            again = tfa.flash_attention(tq, tk, tv, causal=True)
        assert tfa.sdpa_forward.plain_calls - sdpa == int(D == 192)
        np.testing.assert_allclose(again.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0, err_msg=str((S, D)))
