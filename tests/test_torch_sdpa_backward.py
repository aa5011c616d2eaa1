"""The library route's backward of the PyTorch port against the JAX package,
on the CPU.

On a TPU the JAX package hands the library shapes (`_shapes_ok_for_lib`:
non-causal, or causal with Sq == Skv; Sq and Skv multiples of 128; head
dims that are multiples of 64) to jax's library flash kernel and its
backward; on the CPU it computes them densely. The port runs them through
`_LibraryAttention`: B6 with its LSE, then `sdpa_backward`, whose plain
versions run here. Held here, same seeded numpy inputs to both packages,
fp32:
- `sdpa_backward_plain`, from `sdpa_forward_plain`'s O and LSE, against
  `jax.grad` of the dense `_xla_attention` at matmul precision `highest`,
  within 1e-5 (fp32 sums in another order): Sq != Skv both ways at head
  dims 64 to 320, causal Sq == Skv at 192;
- the plain LSE against an fp64 logsumexp of the same logits, within 1e-5;
- `flash_attention` with a gradient at library shapes: the plain versions
  counted once each, nothing dense, output and gradients held to JAX's
  `flash_attention` and `jax.grad` of it.
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


@pytest.mark.parametrize("Sq,Skv,D,causal", [
    *[(128, 256, D, False) for D in (64, 128, 192, 256, 320)],
    *[(256, 128, D, False) for D in (64, 128, 192, 256, 320)],
    (256, 256, 192, True),
])
def test_plain_backward_matches_jax_grad_of_dense_attention(Sq, Skv, D,
                                                            causal):
    """dq, dk, dv of `sdpa_backward_plain` in `[BH, S, D]` against
    `jax.grad` of `_xla_attention` in `[B, H, S, D]`, B 1, H 2."""
    B, H = 1, 2
    q, k, v, do = _rand(Sq * 7 + Skv + D, (B, H, Sq, D), (B, H, Skv, D),
                        (B, H, Skv, D), (B, H, Sq, D))
    scale = 1.0 / math.sqrt(D)
    with jax.default_matmul_precision("highest"):
        want = jax.grad(lambda a, b, c: jnp.sum(
            jfa._xla_attention(a, b, c, causal, scale) * do),
            argnums=(0, 1, 2))(q, k, v)
    qh, kh, vh, doh = (torch.from_numpy(x).reshape(B * H, -1, D)
                       for x in (q, k, v, do))
    o, lse = tfa.sdpa_forward_plain(qh, kh, vh, scale, causal,
                                    return_lse=True)
    plain = tfa.sdpa_backward.plain_calls
    got = tfa.sdpa_backward(qh, kh, vh, o, doh, lse, scale, causal)
    assert tfa.sdpa_backward.plain_calls == plain + 1
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.reshape(w.shape).numpy(), np.asarray(w),
                                   atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("Sq,Skv,D,causal", [(128, 384, 64, False),
                                             (384, 128, 256, False),
                                             (256, 256, 192, True)])
def test_plain_lse_matches_fp64_logsumexp(Sq, Skv, D, causal):
    """`sdpa_forward_plain(..., return_lse=True)`: the LSE in fp32 against
    logsumexp of the fp64 logits (causal: keys after the query at -1e30),
    and O the same bits as without the LSE."""
    q, k, v = _rand(Sq + Skv + D, (2, Sq, D), (2, Skv, D), (2, Skv, D))
    scale = 1.0 / math.sqrt(D)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = tfa.sdpa_forward_plain(tq, tk, tv, scale, causal,
                                    return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, Sq)
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    if causal:
        s = np.where(np.tril(np.ones((Sq, Skv), bool)), s, -1e30)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, atol=ATOL, rtol=0)
    assert torch.equal(o, tfa.sdpa_forward_plain(tq, tk, tv, scale, causal))


def _counts():
    return (tfa.sdpa_forward.plain_calls, tfa.sdpa_backward.plain_calls,
            tfa.shortseq_attention_fwd.plain_calls,
            tfa.causal_attention_fwd.plain_calls,
            tfa.flash_attention.dense_calls)


@pytest.mark.parametrize("qs,kvs,causal", [
    ((2, 128, 2, 64), (2, 384, 2, 64), False),     # cross-attention
    ((1, 640, 2, 64), (1, 640, 2, 64), False),     # a long encoder
    ((1, 256, 1, 192), (1, 256, 1, 192), True),
    ((1, 128, 1, 320), (1, 256, 1, 320), False),
])
def test_flash_attention_with_a_gradient_takes_the_library_backward(
        qs, kvs, causal):
    """`flash_attention` with inputs that require grad, at library shapes:
    `_LibraryAttention` runs B6's plain version with its LSE once and the
    backward's plain version once, nothing else and nothing dense; the
    output within 1e-5 of JAX's `flash_attention` and the gradients within
    1e-5 of `jax.grad` of it."""
    q, k, v, do = _rand(sum(qs) + sum(kvs), qs, kvs, kvs, qs)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jfa.flash_attention(q, k, v, causal=causal))
        jgrads = jax.grad(lambda a, b, c: jnp.sum(
            jfa.flash_attention(a, b, c, causal=causal) * do),
            argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = _counts()
    got = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 0, 0, 0, 0)
    got.backward(torch.from_numpy(do))
    assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 1, 0, 0, 0)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=0)
    for name, t, j in zip(("dq", "dk", "dv"), (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_library_backward_refuses_causal_cross_attention():
    """Causal is defined at Sq == Skv only, on every device, as B6."""
    q, k = (torch.from_numpy(x) for x in _rand(5, (2, 128, 64),
                                                (2, 256, 64)))
    lse = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="Sq == Skv"):
        tfa.sdpa_backward(q, k, k, q, q, lse, causal=True)
